"""PGHI inversion on the card: magnitude -> phases -> audio (twin of the JAX
``ops/pallas/pghi_kernel.py``).

Two hand-written kernels (``csrc/pghi.cu``): the recurrence (log-magnitude,
phase gradients, anchor mask, two-sided segmented fill along bins, the serial
trapezoid recurrence over frames, silent-bin phases from an input), one thread
block per clip, and the synthesis (``mag * e^{i phase}``, windowed inverse DFT
and overlap-add), one block per clip and tile of output chunks.  The synthesis
has two routes, picked by ``n_fft`` alone (``frames_fft.fft_covers``): where
``n_fft`` is a power of two from 64 to 4096 the FFT route
(``csrc/fft_smem.cuh:frames_irfft``: an inverse FFT of every frame, the
overlap-add by classes, no basis; plain version ``frames_irfft_reference`` and
``overlap_add_classes``), elsewhere the product route (a window-folded basis
of ``(overlap, 2F, hop)``, the inverse DFT and the overlap-add in one
product).  ``routes`` counts its launches by route.  ``pghi_invert_fused`` is
the recurrence followed by the synthesis; the envelope division and the
centre trim run outside on the small audio tensor, as they do in the JAX
package.

Entry points: :func:`pghi_phases_fused`, :func:`pghi_phases_bidir`,
:func:`pghi_synthesize_fused`, :func:`pghi_invert_fused`,
:func:`pghi_invert_bidir`.  On a CUDA tensor each launches its kernels or
raises; on a CPU tensor it runs the plain PyTorch version beside it
(``*_reference``), which repeats the kernel's arithmetic in the kernel's order
of additions and is what the kernels are held against on the card.

Semantics are those of ``ops/pghi.py:pghi_scan(time_stencil="central")``
followed by the least-squares ISTFT.  Phases are not wrapped; see the note on
float32 in ``ops/pghi.py``.  ``bidir`` seeds at frame ``T // 2`` and integrates
both halves from it (two blocks per clip, half the serial depth); its output
differs from the causal scan's (another integration order).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F_

from ..fft import _idft_matrices, _tables
from ..framing import overlap_add
from ..pghi import EPS, random_angles
from . import _build
from .frames_fft import (
    class_plan,
    fft_covers,
    fft_smem_floats,
    fft_twiddles,
    frames_irfft_reference,
    irfft_window,
    overlap_add_classes,
)
from .glstep import _env_rows

__all__ = [
    "pghi_invert_fused", "pghi_invert_fused_reference",
    "pghi_phases_fused", "pghi_phases_fused_reference",
    "pghi_phases_bidir", "pghi_phases_bidir_reference",
    "pghi_invert_bidir", "pghi_invert_bidir_reference",
    "pghi_synthesize_fused", "pghi_synthesize_fused_reference",
    "pghi_fused_available", "pghi_phases_available",
    "ola_supported", "pghi_dispatch",
    "launches", "routes", "reset_launches",
]

MAX_SMEM = 232448                 # bytes of shared memory a block may use on sm_90
SYNTH_ROWS = (40, 16, 8)          # output chunks per synthesis block, widest first
_SYN_KC, _SYN_COLS = 32, 256      # staged contraction rows / sample columns (synth_ola.cuh)

#: kernel launches made by the wrappers of this module, by kernel
launches: Dict[str, int] = {"pghi_phases": 0, "pghi_synthesize": 0}
#: the synthesis's launches by route, ``"pghi_synthesize:fft"`` /
#: ``":product"`` (each also counts in ``launches``)
routes: Dict[str, int] = {"pghi_synthesize:fft": 0, "pghi_synthesize:product": 0}


def reset_launches() -> None:
    for d in (launches, routes):
        for k in d:
            d[k] = 0


# ------------------------------------------------------------------ gates
def _bins_per_thread(n_bins: int) -> Optional[int]:
    """Adjacent bins a thread of the recurrence owns (a block has at most 32
    warps), or None above 4096 bins."""
    for bpt in (1, 2, 4):
        if n_bins <= 1024 * bpt:
            return bpt
    return None


def _k_padded(n_bins: int) -> int:
    return -(-2 * n_bins // _SYN_KC) * _SYN_KC


def _synth_smem_bytes(rows: int, overlap: int, k_padded: int) -> int:
    """Shared memory of one synthesis block, as ``csrc/pghi.cu`` lays it out."""
    return 4 * ((rows + overlap - 1) * k_padded + _SYN_KC * _SYN_COLS)


def _synth_fft_smem_bytes(rows: int, hop: int, n_fft: int, teams: int) -> int:
    """Shared memory of one synthesis block on the FFT route: the samples of
    ``rows`` chunks and ``frames_irfft``'s area (the synthesis window in the
    window's place)."""
    return 4 * (rows * hop + fft_smem_floats(n_fft, teams))


def _synth_fft_plan(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(rows, teams)`` of the FFT route's synthesis block: ``rows`` output
    chunks, a multiple of ``2 overlap``, behind which it synthesizes ``rows +
    2 overlap`` frames (``frames_fft.class_plan``; 56 chunks and 4 FFTs at
    1024/256)."""
    return class_plan(n_fft, hop, lambda rows, teams: _synth_fft_smem_bytes(rows, hop, n_fft, teams),
                      widest=max(64, 2 * (n_fft // hop)))


def _pick_rows(n_fft: int, hop: int) -> Optional[int]:
    kp = _k_padded(n_fft // 2 + 1)
    for rows in SYNTH_ROWS:
        if _synth_smem_bytes(rows, n_fft // hop, kp) <= MAX_SMEM:
            return rows
    return None


def pghi_phases_available(n_fft: int, hop_length: int) -> bool:
    """Gate of the phases-only entry points: ``hop | n_fft``, overlap >= 2 and
    at most 4096 bins (what one block of the recurrence holds)."""
    return (
        n_fft % hop_length == 0
        and n_fft // hop_length >= 2
        and _bins_per_thread(n_fft // 2 + 1) is not None
    )


def pghi_fused_available(n_fft: int, hop_length: int) -> bool:
    """Gate of the entry points that synthesize: the phases gate, a hop that
    is a multiple of 4 (16-byte rows), and a synthesis tile that fits shared
    memory (n_fft up to 4096 at overlap 4)."""
    return (
        pghi_phases_available(n_fft, hop_length)
        and hop_length % 4 == 0
        and _pick_rows(n_fft, hop_length) is not None
    )


_LANE, _MAX_Q = 128, 16           # the JAX package's OLA layouts (ops/pallas/ola.py)


def ola_supported(n_fft: int, hop: int) -> bool:
    """The JAX package's structural condition on an overlap-add layout
    (``ops/pallas/ola.py:ola_supported``): a hop that is a multiple of 128, or
    ``n_fft % 128 == 0`` with frames packed into whole 128-sample rows (a hop
    dividing 128, or at most 16 frames to a packed row).  The JAX package
    runs every other layout eagerly; the port's kernels take those it can
    (:func:`pghi_dispatch`)."""
    if hop % _LANE == 0:
        return True
    if n_fft % _LANE != 0:
        return False
    return _LANE % hop == 0 or _LANE // math.gcd(hop, _LANE) <= _MAX_Q


def pghi_dispatch(mode: str, n_fft: int, hop: int) -> str:
    """How an offline PGHI call runs on a CUDA tensor, as data.  A shape goes
    to the eager formulation only where the JAX package's structural gate
    (its ``pghi_fused_available`` / ``pghi_phases_available``, which
    ``STFT.invert`` reads on a TPU) refuses it and the port's kernels cannot
    take it either:

    * ``mode`` ``"pghi"`` / ``"pghi_bidir"``: ``"fused"`` (the recurrence and
      the synthesis kernels, causal or bidirectional) where the kernels cover
      the shape (:func:`pghi_fused_available`) or the JAX package's fused gate
      holds (``hop | n_fft``, overlap >= 2, a supported overlap-add layout);
      else as ``"phases"``;
    * ``mode`` ``"phases"`` (``STFT.pghi``, the seed of ``pghi_gl``):
      ``"phases"`` (the recurrence kernel, then the eager ISTFT where audio is
      wanted) where ``hop | n_fft`` and overlap >= 2, else ``"eager"``
      (``pghi_scan`` and the ISTFT).

    A shape inside the JAX package's gates but beyond a kernel's own limits
    (more than 4096 bins, ``hop % 4``, shared memory) raises
    ``NotImplementedError`` at the launch; it is never sent down the eager
    route."""
    if mode not in ("pghi", "pghi_bidir", "phases"):
        raise ValueError("unknown PGHI dispatch mode %r" % mode)
    phases = n_fft % hop == 0 and n_fft // hop >= 2
    if mode != "phases" and (pghi_fused_available(n_fft, hop) or (phases and ola_supported(n_fft, hop))):
        return "fused"
    return "phases" if phases else "eager"


# --------------------------------------------------------- shared plumbing
def _as_btf(mag: torch.Tensor, n_fft: int) -> Tuple[torch.Tensor, tuple]:
    if mag.ndim < 2 or mag.shape[-1] != n_fft // 2 + 1:
        raise ValueError(
            "expected magnitudes (..., T, %d) for n_fft=%d, got %s"
            % (n_fft // 2 + 1, n_fft, tuple(mag.shape))
        )
    T, n_bins = mag.shape[-2:]
    return mag.reshape((-1, T, n_bins)).to(torch.float32).contiguous(), tuple(mag.shape[:-2])


def _abstol(m: torch.Tensor, tolerance: float) -> torch.Tensor:
    """``max(tol * max|mag|, eps)`` over the whole clip, ``(B,)``."""
    return torch.clamp_min(tolerance * m.amax(dim=(-2, -1)), EPS)


def _angles_for(m, angles, generator):
    if angles is None:
        return random_angles(m.shape, m.device, generator)
    return angles.reshape(m.shape).to(torch.float32).contiguous()


def _chains(T: int, bidir: bool) -> List[Tuple[List[int], List[int], List[int], List[float], List[bool]]]:
    """Per chain the steps as ``(previous, current, next frame, sign, store)``;
    frame -1 is the all-zero frame before the clip."""
    if not bidir:
        s = range(T)
        return [([t - 1 for t in s], list(s), [min(t + 1, T - 1) for t in s],
                 [1.0] * T, [True] * T)]
    mid = T // 2
    right = range(mid, T)
    chain0 = ([t - 1 for t in right], list(right), [min(t + 1, T - 1) for t in right],
              [1.0] * len(right), [True] * len(right))
    left = range(mid - 1, -1, -1)
    # the left chain first repeats the right chain's seed step, unstored
    chain1 = ([mid - 1] + [t + 1 for t in left], [mid] + list(left),
              [mid + 1] + [max(t - 1, 0) for t in left],
              [1.0] + [-1.0] * mid, [False] + [True] * mid)
    return [chain0, chain1]


# ------------------------------------------------ plain recurrence (phases)
def _compose(l, r):
    """Apply ``l`` (earlier) then ``r``: the maps ``x -> a x + b`` with a
    distance channel ``d``; ``a`` is 0 or 1, so each channel rounds once."""
    return (l[0] * r[0], l[1] * r[0] + r[1], l[2] * r[0] + r[2])


def _shift(x, s: int):
    """Elements moved ``s`` places up the last axis, identity maps shifted in."""
    fill = (1.0, 0.0, 0.0)
    return tuple(F_.pad(c[..., :-s], (s, 0), value=v) if s < c.shape[-1]
                 else torch.full_like(c, v) for c, v in zip(x, fill))


def _kogge_stone(x):
    n, s = x[0].shape[-1], 1
    while s < n:
        x = _compose(_shift(x, s), x)
        s *= 2
    return x


def _block_scan(e, bpt: int):
    """Inclusive segmented scan up the last axis (length a multiple of
    ``32 * bpt``), composing in the kernel's order: inside a thread's ``bpt``
    bins, over the 32 lanes' totals, over the warps' totals, and then
    ``compose(compose(warps before, lanes before), own prefix)``."""
    lead = e[0].shape[:-1]
    n_pad = e[0].shape[-1]
    e = tuple(c.reshape(lead + (n_pad // (32 * bpt), 32, bpt)) for c in e)
    cols = [tuple(c[..., j] for c in e) for j in range(bpt)]
    for j in range(1, bpt):
        cols[j] = _compose(cols[j - 1], cols[j])
    incl = _kogge_stone(cols[-1])                        # (..., W, 32)
    wt = _kogge_stone(tuple(c[..., -1] for c in incl))   # (..., W)
    wprev = tuple(c[..., None] for c in _shift(wt, 1))
    before = _compose(wprev, _shift(incl, 1))
    out = [_compose(before, col) for col in cols]
    return tuple(
        torch.stack([o[i] for o in out], dim=-1).reshape(lead + (n_pad,)) for i in range(3)
    )


def _run_chain(m, ang, abstol, steps, fmul, carrier, dtype, out):
    """One chain of the recurrence on ``m (B, T, F)`` float32; writes the
    stored steps' phases into ``out (B, T, F)`` of ``dtype``.  The masks come
    from the float32 magnitudes whatever ``dtype`` is, so a float64 run takes
    the same discrete decisions and differs by rounding only."""
    fp, fc, fn, sgn, store = steps
    B, T, n_bins = m.shape
    dev = m.device
    bpt = _bins_per_thread(n_bins)
    n_pad = -(-n_bins // (32 * bpt)) * 32 * bpt
    mz = torch.cat([m, m.new_zeros((B, 1, n_bins))], dim=1)   # index -1: the zero frame
    ix = lambda f: torch.as_tensor(f, device=dev) % (T + 1)
    Mp, Mc, Mn = (mz.index_select(1, ix(f)) for f in (fp, fc, fn))
    sg = torch.as_tensor(sgn, device=dev, dtype=dtype)[None, :, None]
    Yp, Yc, Yn = (torch.log(torch.clamp_min(x, EPS).to(dtype)) for x in (Mp, Mc, Mn))
    k = torch.arange(n_bins, device=dev, dtype=dtype)
    ck = carrier * k

    def tstep(Y):
        up = torch.cat([Y[..., 1:], Y[..., -1:]], dim=-1)
        dn = torch.cat([Y[..., :1], Y[..., :-1]], dim=-1)
        # times 1 / fmul, as the kernel does (a division by a constant rounds
        # otherwise, by up to an ulp)
        return ((up - dn) * 0.5) * (1.0 / fmul) + ck

    ct = sg * ((tstep(Yp) + tstep(Yc)) * 0.5)
    fs = sg * (-fmul * ((Yn - Yp) * 0.5)) + math.pi
    del Yp, Yc, Yn
    trap = (fs[..., 1:] + fs[..., :-1]) * 0.5
    zero = torch.zeros_like(fs[..., :1])
    sup = torch.cat([zero, trap], dim=-1)
    sdn = torch.cat([-trap, zero], dim=-1)
    del fs, trap
    thr = abstol[:, None, None]
    sig = Mc > thr
    mpad = F_.pad(Mc, (1, 1), value=-1.0)
    anch = sig & (Mp > thr) & (Mc >= mpad[..., :-2]) & (Mc >= mpad[..., 2:])
    onset = ~anch.any(dim=-1, keepdim=True)
    anch = anch | (onset & sig & (Mc == Mc.amax(dim=-1, keepdim=True)))
    any_anchor = anch.any(dim=-1, keepdim=True)
    del Mp, Mn, mpad

    big = float(10 * n_bins)
    phi = torch.zeros((B, n_bins), device=dev, dtype=dtype)
    for s in range(len(fc)):
        phi = _fill_frame(phi, ct[:, s], anch[:, s], sup[:, s], sdn[:, s], any_anchor[:, s],
                          sig[:, s], ang[:, fc[s]], bpt, n_pad, big, dtype)
        if store[s]:
            out[:, fc[s]] = phi


def _fill_frame(phi, ct, a_s, sup, sdn, any_anchor, sig, ang, bpt, n_pad, big, dtype):
    """One frame of the recurrence on ``(B, F)`` rows, in the kernel's order:
    ``phi + ct`` at the anchors, the two-sided segmented fill from them, the
    anchored / filled select, the silent bins' angles.  Returns the frame's
    phases."""
    n_bins = phi.shape[-1]
    pad = (0, n_pad - n_bins)
    phi_t = phi + ct
    a0 = (~a_s).to(dtype)
    b_up = torch.where(a_s, phi_t, sup)
    b_dn = torch.where(a_s, phi_t, sdn)
    # both directions in one scan: the downward one runs up the flipped
    # padded row (identity maps first, which change nothing)
    a2 = torch.stack([F_.pad(a0, pad, value=1.0), F_.pad(a0, pad, value=1.0).flip(-1)])
    b2 = torch.stack([F_.pad(b_up, pad), F_.pad(b_dn, pad).flip(-1)])
    d2 = torch.stack([F_.pad(a0, pad), F_.pad(a0, pad).flip(-1)])
    sa, sb, sd = _block_scan((a2, b2, d2), bpt)
    a_u, f_up, d_up = sa[0, :, :n_bins], sb[0, :, :n_bins], sd[0, :, :n_bins]
    a_d, f_dn, d_dn = (x[1].flip(-1)[:, :n_bins] for x in (sa, sb, sd))
    du = torch.where(a_u == 0, d_up, big)
    dd = torch.where(a_d == 0, d_dn, big)
    filled = torch.where(du <= dd, f_up, f_dn)     # a tie takes the fill from below
    filled = torch.where(any_anchor, filled, torch.zeros_like(filled))
    phi = torch.where(a_s, phi_t, filled)
    return torch.where(sig, phi, ang.to(dtype))


def _phases_reference(m, ang, gamma, n_fft, hop, tolerance, bidir, dtype):
    T = m.shape[1]
    fmul = float(gamma) / (hop * n_fft)
    carrier = 2.0 * math.pi * hop / n_fft
    out = torch.empty(m.shape, device=m.device, dtype=dtype)
    for steps in _chains(T, bidir and T >= 4):
        _run_chain(m, ang, _abstol(m, tolerance), steps, fmul, carrier, dtype, out)
    return out


def pghi_phases_fused_reference(
    mag, gamma, n_fft, hop_length, tolerance=1e-2, generator=None, angles=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pghi_phases_fused`.  ``dtype=float64``
    runs the same recurrence (same masks, same order) in double precision:
    the yardstick for what float32 costs at a given clip length."""
    m, batch_shape = _as_btf(mag, n_fft)
    ang = _angles_for(m, angles, generator)
    ph = _phases_reference(m, ang, gamma, n_fft, hop_length, tolerance, False, dtype)
    return ph.reshape(batch_shape + ph.shape[1:])


def pghi_phases_bidir_reference(
    mag, gamma, n_fft, hop_length, tolerance=1e-2, generator=None, angles=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pghi_phases_bidir`."""
    m, batch_shape = _as_btf(mag, n_fft)
    ang = _angles_for(m, angles, generator)
    ph = _phases_reference(m, ang, gamma, n_fft, hop_length, tolerance, True, dtype)
    return ph.reshape(batch_shape + ph.shape[1:])


# ------------------------------------------------------------- synthesis
def _windowed_idft(window: torch.Tensor, n_fft: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse real-DFT matrices ``(F, n_fft)`` with the synthesis window folded in."""
    A, Bm = _tables(_idft_matrices, window.device, n_fft)
    w = window.to(torch.float32)[None, :]
    return A * w, Bm * w


def _synth_basis(window: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """The kernel's basis ``(overlap, Kp, hop)``: rows ``[A; B; 0]`` of the
    windowed inverse DFT, cut into ``overlap`` pieces of ``hop`` samples."""
    n_bins = n_fft // 2 + 1
    kp = _k_padded(n_bins)
    Aw, Bw = _windowed_idft(window, n_fft)
    ab = torch.cat([Aw, Bw, Aw.new_zeros((kp - 2 * n_bins, n_fft))], dim=0)
    return ab.reshape(kp, n_fft // hop, hop).permute(1, 0, 2).contiguous()


def _finish_audio(y, window, T, n_fft, hop, length, batch_shape):
    """Least-squares envelope division and centre trim of the overlap-add
    signal ``(B, (T - 1) hop + n_fft)`` (torch ISTFT conventions)."""
    y = y / _env_rows(T, n_fft, hop, window.to(y.device)).reshape(-1)
    start = n_fft // 2
    stop = (T - 1) * hop + n_fft - (n_fft - n_fft // 2) if length is None else start + length
    y = y[..., start:stop]
    if length is not None and y.shape[-1] < length:
        y = F_.pad(y, (0, length - y.shape[-1]))
    return y.reshape(batch_shape + y.shape[-1:])


def pghi_synthesize_fused_reference(mag, phases, n_fft, hop_length, window, length=None):
    """Plain PyTorch version of :func:`pghi_synthesize_fused`, on the route
    the kernel takes: where ``fft_covers(n_fft)`` the FFT route's schedule
    (``frames_irfft_reference`` with pair stride ``overlap`` over the whole
    clip, then ``overlap_add_classes``), elsewhere the window-folded inverse
    DFT as two products and one overlap-add."""
    m, batch_shape = _as_btf(mag, n_fft)
    ph = phases.reshape(m.shape).to(torch.float32)
    re, im = m * torch.cos(ph), m * torch.sin(ph)
    if fft_covers(n_fft):
        w = irfft_window(window.to(m.device), n_fft)
        y = overlap_add_classes(frames_irfft_reference(re, im, w, stride=n_fft // hop_length), hop_length)
    else:
        Aw, Bw = _windowed_idft(window.to(m.device), n_fft)
        y = overlap_add(torch.matmul(re, Aw) + torch.matmul(im, Bw), hop_length)
    return _finish_audio(y, window, m.shape[1], n_fft, hop_length, length, batch_shape)


def pghi_invert_fused_reference(
    mag, gamma, n_fft, hop_length, window, tolerance=1e-2, length=None, generator=None,
    angles=None,
):
    """Plain PyTorch version of :func:`pghi_invert_fused`."""
    ph = pghi_phases_fused_reference(mag, gamma, n_fft, hop_length, tolerance, generator, angles)
    return pghi_synthesize_fused_reference(mag, ph, n_fft, hop_length, window, length)


def pghi_invert_bidir_reference(
    mag, gamma, n_fft, hop_length, window, tolerance=1e-2, length=None, generator=None,
    angles=None,
):
    """Plain PyTorch version of :func:`pghi_invert_bidir`."""
    ph = pghi_phases_bidir_reference(mag, gamma, n_fft, hop_length, tolerance, generator, angles)
    return pghi_synthesize_fused_reference(mag, ph, n_fft, hop_length, window, length)


# ---------------------------------------------------------------- kernels
def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch_phases(m, ang, gamma, n_fft, hop, tolerance, bidir) -> torch.Tensor:
    if pghi_dispatch("phases", n_fft, hop) == "eager":
        raise ValueError(
            "the CUDA PGHI recurrence does not cover n_fft=%d hop=%d (needs hop | n_fft "
            "and overlap >= 2)" % (n_fft, hop)
        )
    if not pghi_phases_available(n_fft, hop):
        raise NotImplementedError(
            "the CUDA PGHI recurrence holds a frame's bins in one block, at most 4096; "
            "n_fft=%d has %d (ROADMAP Queue 2, K6)" % (n_fft, n_fft // 2 + 1)
        )
    B, T, n_bins = m.shape
    out = torch.empty_like(m)
    abstol = _abstol(m, tolerance).contiguous()
    lib = _build.load_library()
    with torch.cuda.device(m.device):
        code = lib.att_pghi_phases(
            m.data_ptr(), ang.data_ptr(), abstol.data_ptr(), out.data_ptr(), B, T, n_bins,
            float(gamma) / (hop * n_fft), (hop * n_fft) / float(gamma), 2.0 * math.pi * hop / n_fft,
            int(bidir and T >= 4), _bins_per_thread(n_bins), _stream(),
        )
    _build.check(code, "pghi_phases")
    launches["pghi_phases"] += 1
    return out


def _require_synthesis(n_fft: int, hop: int) -> None:
    """Raise unless the synthesis kernel covers the shape: it never gives way.
    ``ValueError`` outside the structural gate (:func:`pghi_dispatch`),
    ``NotImplementedError`` inside it where a kernel's limit bites."""
    if pghi_fused_available(n_fft, hop):
        return
    if pghi_dispatch("pghi", n_fft, hop) == "fused":
        raise NotImplementedError(
            "the CUDA PGHI kernels need hop %% 4 == 0, at most 4096 bins and a synthesis "
            "block that fits shared memory; n_fft=%d hop=%d misses one (ROADMAP Queue 2, K6)"
            % (n_fft, hop)
        )
    raise ValueError(
        "the CUDA PGHI synthesis does not cover n_fft=%d hop=%d (needs hop | n_fft, "
        "overlap >= 2 and a supported overlap-add layout)" % (n_fft, hop)
    )


def _launch_synthesize(m, ph, n_fft, hop, window) -> torch.Tensor:
    _require_synthesis(n_fft, hop)
    B, T, n_bins = m.shape
    overlap = n_fft // hop
    out = torch.empty((B, (T + overlap - 1) * hop), dtype=torch.float32, device=m.device)
    lib = _build.load_library()
    fft = fft_covers(n_fft)
    with torch.cuda.device(m.device):
        if fft:
            rows, teams = _synth_fft_plan(n_fft, hop)
            wsyn = irfft_window(window.to(m.device), n_fft).contiguous()
            (tw,) = _tables(fft_twiddles, m.device, n_fft)
            code = lib.att_pghi_synthesize_fft(
                m.data_ptr(), ph.data_ptr(), wsyn.data_ptr(), tw.data_ptr(), out.data_ptr(), B, T,
                n_bins, hop, overlap, rows, teams, _stream(),
            )
        else:
            basis = _synth_basis(window.to(m.device), n_fft, hop)
            code = lib.att_pghi_synthesize(
                m.data_ptr(), ph.data_ptr(), basis.data_ptr(), out.data_ptr(), B, T, n_bins, hop,
                overlap, basis.shape[1], _pick_rows(n_fft, hop), _stream(),
            )
    _build.check(code, "pghi_synthesize")
    launches["pghi_synthesize"] += 1
    routes["pghi_synthesize:fft" if fft else "pghi_synthesize:product"] += 1
    return out


def _phases(mag, gamma, n_fft, hop, tolerance, generator, angles, bidir):
    m, batch_shape = _as_btf(mag, n_fft)
    ang = _angles_for(m, angles, generator)
    if m.is_cuda:
        ph = _launch_phases(m, ang, gamma, n_fft, hop, tolerance, bidir)
    else:
        ph = _phases_reference(m, ang, gamma, n_fft, hop, tolerance, bidir, torch.float32)
    return ph.reshape(batch_shape + ph.shape[1:])


def pghi_phases_fused(
    mag: torch.Tensor,
    gamma: float,
    n_fft: int,
    hop_length: int,
    tolerance: float = 1e-2,
    generator: Optional[torch.Generator] = None,
    angles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Offline PGHI phases ``mag (..., T, F) -> (..., T, F)`` in one kernel:
    ``pghi_scan(mag, ..., time_stencil="central")`` with the frame recurrence
    inside the kernel.  Silent bins take ``angles`` (the shape of ``mag``) or a
    draw from ``generator`` (on ``mag``'s device; seeded with 0 when None)."""
    return _phases(mag, gamma, n_fft, hop_length, tolerance, generator, angles, False)


def pghi_phases_bidir(
    mag: torch.Tensor,
    gamma: float,
    n_fft: int,
    hop_length: int,
    tolerance: float = 1e-2,
    generator: Optional[torch.Generator] = None,
    angles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional offline PGHI phases: seed at frame ``T // 2`` (with its
    true neighbours as context) and integrate the right half forward and the
    left half backward from the seed's phase, two blocks per clip.  One
    coherent integration, in another order than the causal scan, so the
    phases differ from :func:`pghi_phases_fused`; below 4 frames it is the
    causal kernel."""
    return _phases(mag, gamma, n_fft, hop_length, tolerance, generator, angles, True)


def pghi_synthesize_fused(
    mag: torch.Tensor,
    phases: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    length: Optional[int] = None,
) -> torch.Tensor:
    """``istft(mag * e^{i phases})`` by the synthesis kernel (windowed inverse
    DFT and overlap-add: an FFT a frame where ``fft_covers(n_fft)``, else one
    product; torch ISTFT conventions).  ``window`` is the synthesis window."""
    if not mag.is_cuda:
        return pghi_synthesize_fused_reference(mag, phases, n_fft, hop_length, window, length)
    m, batch_shape = _as_btf(mag, n_fft)
    ph = phases.reshape(m.shape).to(torch.float32).contiguous()
    y = _launch_synthesize(m, ph, n_fft, hop_length, window)
    return _finish_audio(y, window, m.shape[1], n_fft, hop_length, length, batch_shape)


def _invert(mag, gamma, n_fft, hop, window, tolerance, length, generator, angles, bidir):
    if mag.is_cuda:
        _require_synthesis(n_fft, hop)   # before the recurrence runs for nothing
    ph = _phases(mag, gamma, n_fft, hop, tolerance, generator, angles, bidir)
    return pghi_synthesize_fused(mag, ph, n_fft, hop, window, length)


def pghi_invert_fused(
    mag: torch.Tensor,
    gamma: float,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    tolerance: float = 1e-2,
    length: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    angles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Offline PGHI inversion ``mag (..., T, F) -> audio``: the phases kernel
    followed by the synthesis kernel.  Equal to ``istft(mag * exp(1j *
    pghi_scan(mag, ...)), window)`` up to float32 rounding."""
    return _invert(mag, gamma, n_fft, hop_length, window, tolerance, length, generator, angles, False)


def pghi_invert_bidir(
    mag: torch.Tensor,
    gamma: float,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    tolerance: float = 1e-2,
    length: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    angles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional offline PGHI inversion: :func:`pghi_phases_bidir`
    followed by :func:`pghi_synthesize_fused`."""
    return _invert(mag, gamma, n_fft, hop_length, window, tolerance, length, generator, angles, True)
