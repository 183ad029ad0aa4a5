"""PGHI inversion on the card: magnitude -> phases -> audio (twin of the JAX
``ops/pallas/pghi_kernel.py``).

Three hand-written kernels (``csrc/pghi.cu``).  The recurrence is two
launches: the plan (``pghi_plan_kernel``: the magnitude-only work of every
frame of every clip at once, a block a tile of frames, a warp a frame:
log-magnitudes, phase gradients, anchor mask, and the two-sided segmented
fill along bins, shared with the streaming recurrence, giving every bin its
source bin and ``off = ct[src] + seg``), and the walk (``pghi_walk_kernel``,
one block a chain: ``phi_t = phi_{t-1}[src] + off`` frame by frame, silent
bins' phases from an input).  The synthesis (``mag * e^{i phase}``, windowed
inverse DFT and overlap-add) runs one block per clip and tile of output
chunks.  The synthesis has three routes, picked by ``(n_fft, hop)`` alone
(:func:`synth_route`): where ``n_fft`` is a power of two from 64 to 4096 the
FFT route (``csrc/fft_smem.cuh:frames_irfft``: an inverse FFT of every
frame, the overlap-add by classes, no basis; plain version
``frames_irfft_reference`` and ``overlap_add_classes``), where
``frames_fft.fft_covers_smooth7(n_fft)`` (even, ``2^a 3^b 5^c 7^d``, no
power of two: 768, 1200, and with a factor 7 896, 1344, 1568, ...) and a
block fits the smooth route (the same kernel's mixed-radix instance, its
radix-7 instance where ``n_fft`` has a factor 7, ``smooth=True`` in the
plain version), elsewhere (1408 = 2^7 11, odd sizes, above 4096) the
product route (a window-folded basis of ``(overlap, 2F, hop)``, the inverse
DFT and the overlap-add in one product).  ``routes`` counts its launches by
route.  ``pghi_invert_fused`` is the recurrence followed by the synthesis;
the envelope division and the centre trim run outside on the small audio
tensor, as they do in the JAX package.

Entry points: :func:`pghi_phases_fused`, :func:`pghi_phases_bidir`,
:func:`pghi_synthesize_fused`, :func:`pghi_invert_fused`,
:func:`pghi_invert_bidir`; the recurrence's two launches apart,
:func:`pghi_plan` and :func:`pghi_walk`.  On a CUDA tensor each launches its
kernels or raises; on a CPU tensor it runs the plain PyTorch version beside
it (``*_reference``), which repeats the kernel's arithmetic in the kernel's
order of additions and is what the kernels are held against on the card.

Semantics are those of ``ops/pghi.py:pghi_scan(time_stencil="central")``
followed by the least-squares ISTFT.  Phases are not wrapped; see the note on
float32 in ``ops/pghi.py``.  ``bidir`` seeds at frame ``T // 2`` and integrates
both halves from it (two walk blocks per clip, half the serial depth); its
output differs from the causal scan's (another integration order).
"""
from __future__ import annotations

import ctypes
import functools
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
    class_plan_smooth,
    fft_area_floats,
    fft_covers,
    fft_covers_smooth7,
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
    "pghi_plan", "pghi_plan_reference", "pghi_walk", "pghi_walk_reference", "fill_sources",
    "pghi_fused_available", "pghi_phases_available",
    "ola_supported", "pghi_dispatch", "synth_route",
    "launches", "routes", "reset_launches",
]

MAX_SMEM = 232448                 # bytes of shared memory a block may use on sm_90
MAX_BINS = 4096                   # bins K's recurrence takes
PLAN_TILES = (4, 2, 1)            # frames a plan block takes, widest first (at most csrc/pghi.cu: kPlanTile)
WALK_SLOTS = (4, 2)               # ring slots of a walk block, 4 plan rows each (kWalkGroup), most first
_WALK_QUADS = 2                   # groups of 4 bins a walk chain thread owns, at most (kWalkQuads)
_FILL_E = 4                       # bins a lane owns in a tile of the fill's scans (kFillE)
_FILL_TILE = 32 * _FILL_E         # bins a warp's scan covers at a time
SYNTH_ROWS = (40, 16, 8)          # output chunks per synthesis block, widest first
_SYN_KC, _SYN_COLS = 32, 256      # staged contraction rows / sample columns (synth_ola.cuh)

#: kernel launches made by the wrappers of this module, by kernel: the
#: recurrence's plan (``pghi_plan``) and walk (``pghi_phases``, one a
#: recurrence call), the synthesis
launches: Dict[str, int] = {"pghi_plan": 0, "pghi_phases": 0, "pghi_synthesize": 0}
#: the synthesis's launches by route, ``"pghi_synthesize:fft"`` /
#: ``":smooth"`` / ``":product"`` (each also counts in ``launches``)
routes: Dict[str, int] = {"pghi_synthesize:fft": 0, "pghi_synthesize:smooth": 0, "pghi_synthesize:product": 0}


def reset_launches() -> None:
    for d in (launches, routes):
        for k in d:
            d[k] = 0


# ------------------------------------------------------------------ gates
def _plan_row(n_bins: int) -> int:
    """Bins of a row of K's plan: ``n_bins`` rounded up to 8 (16-byte rows)."""
    return -(-n_bins // 8) * 8


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _plan_smem_bytes(n_bins: int, tile: int) -> int:
    """Shared memory of one plan block, as ``csrc/pghi.cu`` lays it out: rows
    of ``n_bins`` rounded up to 4, the magnitudes and logarithms of ``tile +
    2`` frames; a work area of two float rows and one int16 row a frame (at
    least the bulk copy of the halo's magnitudes, which it holds first); an
    mbarrier."""
    row = -(-n_bins // 4) * 4
    work = _round16(max(tile * row * 10, _round16(4 * (tile + 2) * n_bins + 32)))
    return 8 * (tile + 2) * row + work + 16


def _walk_smem_bytes(n_bins: int, slots: int) -> int:
    """Shared memory of one walk block: two phase rows and ``slots`` ring
    slots of 4 plan rows (a float and an int16 a bin), all of
    :func:`_plan_row` bins, and an mbarrier a slot."""
    return _plan_row(n_bins) * (8 + 24 * slots) + 8 * slots


def _phases_plan(n_bins: int, T: int) -> Tuple[int, int, int]:
    """``(tile, warps, slots)`` of K's recurrence, a pure function of
    ``(n_bins, T)``: the plan block's frames (a warp each; the most of
    ``PLAN_TILES`` up to ``T`` that fits shared memory: 4 up to 2640 bins, 2
    above), the walk block's chain warps (a warp for each 128 bins of the
    plan's rows, at most 16: 5 at 513 bins, 16 above 1920, two groups of 4
    bins a thread at most; two side warps besides, for the copies and the
    stores) and its ring slots of 4 plan rows (4, or 2 where 4 do not fit:
    above 2232 bins).  Every ``n_bins <= 4096`` has a plan at any ``T``."""
    if not 2 <= n_bins <= MAX_BINS or T < 1:
        raise ValueError("K's recurrence takes 2 to %d bins and a frame or more" % MAX_BINS)
    tile = next(t for t in PLAN_TILES if t <= T and _plan_smem_bytes(n_bins, t) <= MAX_SMEM)
    warps = min(16, -(-_plan_row(n_bins) // 128))
    slots = next(r for r in WALK_SLOTS if _walk_smem_bytes(n_bins, r) <= MAX_SMEM)
    return tile, warps, slots


def _k_padded(n_bins: int) -> int:
    return -(-2 * n_bins // _SYN_KC) * _SYN_KC


def _synth_smem_bytes(rows: int, overlap: int, k_padded: int) -> int:
    """Shared memory of one synthesis block, as ``csrc/pghi.cu`` lays it out."""
    return 4 * ((rows + overlap - 1) * k_padded + _SYN_KC * _SYN_COLS)


def _synth_fft_smem_bytes(rows: int, hop: int, n_fft: int, teams: int) -> int:
    """Shared memory of one synthesis block on the FFT or smooth route: the
    samples of ``rows`` chunks and ``frames_irfft``'s area on the route
    ``n_fft`` takes (``frames_fft.fft_area_floats``; the synthesis window in
    the window's place)."""
    return 4 * (rows * hop + fft_area_floats(n_fft, teams))


#: blocks an SM the radix-7 instance of K's synthesis
#: (``pghi_synthesize_fft_kernel<true, true>``) runs at the registers its
#: build takes: 256 threads, 65536 registers an SM
SYNTH_SEVEN_BLOCKS = 3


@functools.lru_cache(maxsize=None)
def _synth_fft_plan(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(rows, teams)`` of the FFT or smooth route's synthesis block, or
    None when none fits: ``rows`` output chunks, a multiple of ``2 overlap``,
    behind which it synthesizes ``rows + 2 overlap`` frames.  The FFT route
    (``fft_covers(n_fft)``): ``frames_fft.class_plan`` (56 chunks and 4 FFTs
    at 1024/256); the smooth route (``fft_covers_smooth7(n_fft)``):
    ``frames_fft.class_plan_smooth`` with up to four blocks an SM, the
    decode's rule (its smooth instance is the decode's with the pairs counted
    from the block's first frame, 64 registers as the decode's: 18 chunks
    and 4 FFTs at 768/256, 40 and 2 at 1200/300), and where ``n_fft`` has a
    factor 7 (the radix-7 instance) up to :data:`SYNTH_SEVEN_BLOCKS`."""
    ov = n_fft // hop

    def smem(rows, teams):
        return _synth_fft_smem_bytes(rows, hop, n_fft, teams)

    if fft_covers(n_fft):
        return class_plan(n_fft, hop, smem, widest=max(64, 2 * ov))
    if fft_covers_smooth7(n_fft):
        blocks = SYNTH_SEVEN_BLOCKS if n_fft % 7 == 0 else 4
        return class_plan_smooth(n_fft, hop, smem, widest=max(64, 2 * ov), blocks=blocks)
    return None


def synth_route(n_fft: int, hop: int) -> str:
    """The route of K's synthesis at ``(n_fft, hop)``, read by the kernel
    wrapper and the plain version alike: ``"fft"`` where ``fft_covers(n_fft)``
    (a power of two from 64 to 4096), ``"smooth"`` where
    ``fft_covers_smooth7(n_fft)`` and a smooth block fits
    (:func:`_synth_fft_plan`; the radix-7 instance where ``n_fft`` has a
    factor 7), else ``"product"``."""
    if fft_covers(n_fft):
        return "fft"
    if n_fft % hop == 0 and n_fft // hop >= 2 and fft_covers_smooth7(n_fft) and _synth_fft_plan(n_fft, hop):
        return "smooth"
    return "product"


def _pick_rows(n_fft: int, hop: int) -> Optional[int]:
    kp = _k_padded(n_fft // 2 + 1)
    for rows in SYNTH_ROWS:
        if _synth_smem_bytes(rows, n_fft // hop, kp) <= MAX_SMEM:
            return rows
    return None


def pghi_phases_available(n_fft: int, hop_length: int) -> bool:
    """Gate of the phases-only entry points: ``hop | n_fft``, overlap >= 2 and
    at most 4096 bins (the plan's int16 sources; a walk block's ring)."""
    return (
        n_fft % hop_length == 0
        and n_fft // hop_length >= 2
        and n_fft // 2 + 1 <= MAX_BINS
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
def _constants(gamma: float, n_fft: int, hop: int) -> Tuple[float, float, float]:
    """``(fmul, 1 / fmul, carrier)`` as both recurrences take them."""
    fmul = float(gamma) / (hop * n_fft)
    return fmul, 1.0 / fmul, 2.0 * math.pi * hop / n_fft


def _fill_compose(l, r):
    """Apply ``l`` (earlier) then ``r``: segmented sums with head flags, ``(f,
    b)`` = (the span holds an anchor, the sum of its steps since the last
    one); a head restarts the sum."""
    return l[0] | r[0], torch.where(r[0], r[1], l[1] + r[1])


def _lane_shift(x, s: int):
    """Elements moved ``s`` places up the last axis (the lanes), empty spans
    ``(False, 0)`` shifted in."""
    return tuple(torch.cat([torch.zeros_like(c[..., :s]), c[..., :-s]], dim=-1) for c in x)


def _fill_scan(f: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sums of ``b`` up the last axis (a multiple of 128
    long), restarting at the heads ``f``, in the kernel's order of float32
    additions: a lane's 4 bins of a 128-bin tile in order, a Kogge-Stone
    scan over the 32 lanes' totals, then for each bin ``compose(compose(the
    tiles before, the lanes before), its own prefix)``; the tiles' carry is
    ``compose(carry, the tile's total)``."""
    lead, n = f.shape[:-1], f.shape[-1]
    nt = n // _FILL_TILE
    f = f.reshape(lead + (nt, 32, _FILL_E))
    b = b.reshape(lead + (nt, 32, _FILL_E))
    own = [(f[..., 0], b[..., 0])]
    for e in range(1, _FILL_E):
        own.append(_fill_compose(own[-1], (f[..., e], b[..., e])))
    incl, s = own[-1], 1
    while s < 32:
        incl = _fill_compose(_lane_shift(incl, s), incl)
        s *= 2
    lprev = _lane_shift(incl, 1)
    carry = (torch.zeros_like(f[..., 0, :1, 0]), torch.zeros_like(b[..., 0, :1, 0]))
    out = []
    for i in range(nt):
        before = _fill_compose(carry, (lprev[0][..., i, :], lprev[1][..., i, :]))
        out.append(torch.stack([_fill_compose(before, (o[0][..., i, :], o[1][..., i, :]))[1] for o in own],
                               dim=-1))
        carry = _fill_compose(carry, (incl[0][..., i, 31:], incl[1][..., i, 31:]))
    return torch.stack(out, dim=-3).reshape(lead + (n,))


def fill_sources(mag, peak, sig, fs, const):
    """The fill of both recurrences on every frame at once, the plain version
    of ``csrc/pghi.cu:pghi_plan_frame``: magnitudes ``mag (..., F)`` float32,
    the anchors by the peak rule ``peak``, the audible bins ``sig``, the
    frequency derivatives ``fs`` and a silent bin's constant ``const`` (both
    float32, or float64 for a float64 run) -> ``(src, seg)``.  In a frame
    without a peak anchor the onset rule anchors every audible bin equal to
    the frame's maximum.  An anchor's source is itself, with ``seg = -0.0``;
    another audible bin's is the nearest anchor below or above (a tie takes
    the one below), ``seg`` the sum of the trapezoid steps of ``fs`` from it
    (``_fill_scan``'s order); an audible bin of a frame without an anchor
    and a silent bin have source -1 and ``seg`` 0 or ``const``."""
    anch = peak | (~peak.any(dim=-1, keepdim=True) & sig & (mag == mag.amax(dim=-1, keepdim=True)))
    any_anchor = anch.any(dim=-1, keepdim=True)
    trap = (fs[..., 1:] + fs[..., :-1]) * 0.5
    zero = torch.zeros_like(fs[..., :1])
    sup = torch.cat([zero, trap], dim=-1)
    sdn = torch.cat([-trap, zero], dim=-1)
    del trap
    # the segment sums from the nearest anchor on each side (the downward
    # scan runs up the flipped padded row, empty spans first)
    n_bins = mag.shape[-1]
    pad = (0, -(-n_bins // _FILL_TILE) * _FILL_TILE - n_bins)
    fp = F_.pad(anch, pad)
    seg_up = _fill_scan(fp, F_.pad(torch.where(anch, 0.0, sup), pad))[..., :n_bins]
    seg_dn = _fill_scan(fp.flip(-1), F_.pad(torch.where(anch, 0.0, sdn), pad).flip(-1)).flip(-1)[..., :n_bins]
    del sup, sdn, fp
    k = torch.arange(n_bins, device=mag.device)
    none = 2 * MAX_BINS
    below = torch.cummax(torch.where(anch, k, -1), dim=-1).values
    above = torch.cummin(torch.where(anch, k, none).flip(-1), dim=-1).values.flip(-1)
    du = torch.where(below >= 0, k - below, none)
    dd = torch.where(above < none, above - k, none)
    from_below = du <= dd                        # a tie takes the fill from below
    src = torch.where(from_below, below, above)
    seg = torch.where(from_below, seg_up, seg_dn)
    src = torch.where(anch, k, torch.where(any_anchor, src, -1))
    seg = torch.where(anch, -0.0, torch.where(any_anchor, seg, 0.0))
    return torch.where(sig, src, -1), torch.where(sig, seg, const)


def _orientation(T: int, bidir: bool) -> Tuple[List[int], List[int], List[float]]:
    """Per frame ``t`` its previous and next frame in walking order and the
    walking direction's sign: forward (``t - 1``, ``min(t + 1, T - 1)``,
    +1; frame -1 is the all-zero frame before the clip), or under ``bidir``
    backward for ``t < T // 2`` (``t + 1``, ``max(t - 1, 0)``, -1)."""
    fwd = [not bidir or t >= T // 2 for t in range(T)]
    return ([t - 1 if f else t + 1 for t, f in enumerate(fwd)],
            [min(t + 1, T - 1) if f else max(t - 1, 0) for t, f in enumerate(fwd)],
            [1.0 if f else -1.0 for f in fwd])


def _walk_order(T: int, bidir: bool) -> List[List[Tuple[int, bool]]]:
    """Per chain its steps as ``(frame, stored)``: causal, frames ``0 .. T -
    1``; ``bidir``, chain 0 ``mid .. T - 1`` and chain 1 first chain 0's seed
    step (``mid``, unstored), then ``mid - 1 .. 0``."""
    if not bidir:
        return [[(t, True) for t in range(T)]]
    mid = T // 2
    return [[(t, True) for t in range(mid, T)], [(mid, False)] + [(t, True) for t in range(mid - 1, -1, -1)]]


def _plan(m, ang, gamma, n_fft, hop, tolerance, bidir, dtype):
    """K's plan on ``m (B, T, F)`` float32 -> ``(src, off)``, each ``(B, T,
    F)``: a bin of frame ``t`` takes ``phi_{t-1}[src] + off`` where ``src >=
    0``, else ``off``.  ``off = ct[src] + seg``, in ``dtype``; the masks come
    from the float32 magnitudes whatever ``dtype`` is, so a float64 run takes
    the same discrete decisions and differs by rounding only."""
    B, T, n_bins = m.shape
    dev = m.device
    fmul, inv_fmul, carrier = _constants(gamma, n_fft, hop)
    fp, fn, sgn = _orientation(T, bidir)
    mz = torch.cat([m, m.new_zeros((B, 1, n_bins))], dim=1)   # index -1: the zero frame
    ip, in_ = (torch.as_tensor(f, device=dev) % (T + 1) for f in (fp, fn))
    Yz = torch.log(torch.clamp_min(mz, EPS).to(dtype))
    Yp, Yc, Yn = Yz.index_select(1, ip), Yz[:, :T], Yz.index_select(1, in_)
    del Yz
    sg = torch.as_tensor(sgn, device=dev, dtype=dtype)[None, :, None]
    ck = carrier * torch.arange(n_bins, device=dev, dtype=dtype)

    def tstep(Y):
        up = torch.cat([Y[..., 1:], Y[..., -1:]], dim=-1)
        dn = torch.cat([Y[..., :1], Y[..., :-1]], dim=-1)
        # times 1 / fmul, as the kernel does (a division by a constant rounds
        # otherwise, by up to an ulp)
        return ((up - dn) * 0.5) * inv_fmul + ck

    ct = sg * ((tstep(Yp) + tstep(Yc)) * 0.5)
    fs = sg * (-fmul * ((Yn - Yp) * 0.5)) + math.pi
    del Yp, Yc, Yn
    thr = _abstol(m, tolerance)[:, None, None]
    sig = m > thr
    mpad = F_.pad(m, (1, 1), value=-1.0)
    peak = sig & (mz.index_select(1, ip) > thr) & (m >= mpad[..., :-2]) & (m >= mpad[..., 2:])
    del mz, mpad
    src, seg = fill_sources(m, peak, sig, fs, ang.to(dtype))
    return src, torch.where(src >= 0, ct.gather(-1, src.clamp_min(0)) + seg, seg)


def _walk(src, off, bidir):
    """K's walk over a plan ``(B, T, >= F)``: per chain, ``phi = phi[src] +
    off`` (``off`` where ``src < 0``) frame by frame from zeros, the kernel's
    one addition a bin."""
    B, T, n = off.shape
    src = src.long()
    has, at = src >= 0, src.clamp_min(0)
    out = torch.empty_like(off)
    for chain in _walk_order(T, bidir):
        phi = off.new_zeros((B, n))
        for t, store in chain:
            phi = torch.where(has[:, t], phi.gather(1, at[:, t]) + off[:, t], off[:, t])
            if store:
                out[:, t] = phi
    return out


def _phases_reference(m, ang, gamma, n_fft, hop, tolerance, bidir, dtype):
    bidir = bidir and m.shape[1] >= 4
    return _walk(*_plan(m, ang, gamma, n_fft, hop, tolerance, bidir, dtype), bidir)


def pghi_phases_fused_reference(
    mag, gamma, n_fft, hop_length, tolerance=1e-2, generator=None, angles=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pghi_phases_fused`: the plan over
    every frame at once (:func:`pghi_plan_reference`), then the walk, in the
    kernels' order of float32 operations.  ``dtype=float64`` runs the same
    recurrence (same masks, same order) in double precision: the yardstick
    for what float32 costs at a given clip length."""
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


def _padded_plan(src, off):
    """``(src int16, off)`` padded from F to the kernels' ``Fp`` bins with
    ``(-1, 0)``."""
    pad = (0, _plan_row(src.shape[-1]) - src.shape[-1])
    return F_.pad(src, pad, value=-1).to(torch.int16), F_.pad(off, pad)


def pghi_plan_reference(mag, gamma, n_fft, hop_length, tolerance=1e-2, bidir=False, angles=None):
    """Plain PyTorch version of :func:`pghi_plan`: ``mag (B, T, F)``, the
    silent bins' ``angles`` of its shape -> the plan ``(src, off)``, each
    ``(B, T, Fp)`` (int16 and float32, padded with ``(-1, 0)``)."""
    m, _ = _as_btf(mag, n_fft)
    ang = _angles_for(m, angles, None)
    return _padded_plan(*_plan(m, ang, gamma, n_fft, hop_length, tolerance, bidir and m.shape[1] >= 4,
                               torch.float32))


def pghi_walk_reference(src, off, n_bins: int, bidir=False) -> torch.Tensor:
    """Plain PyTorch version of :func:`pghi_walk`: a plan ``(B, T, Fp)`` ->
    phases ``(B, T, n_bins)``."""
    return _walk(src, off, bidir and src.shape[1] >= 4)[..., :n_bins].contiguous()


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
    the kernel takes (:func:`synth_route`): on the FFT and smooth routes their
    schedule (``frames_irfft_reference`` with pair stride ``overlap`` over the
    whole clip under ``irfft_window``, ``smooth=True`` on the smooth route,
    then ``overlap_add_classes``), elsewhere the window-folded inverse DFT as
    two products and one overlap-add."""
    m, batch_shape = _as_btf(mag, n_fft)
    ph = phases.reshape(m.shape).to(torch.float32)
    re, im = m * torch.cos(ph), m * torch.sin(ph)
    route = synth_route(n_fft, hop_length)
    if route != "product":
        smooth = route == "smooth"
        w = irfft_window(window.to(m.device), n_fft, smooth)
        y = overlap_add_classes(frames_irfft_reference(re, im, w, stride=n_fft // hop_length, smooth=smooth),
                                hop_length)
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


def _require_phases(n_fft: int, hop: int) -> None:
    if pghi_dispatch("phases", n_fft, hop) == "eager":
        raise ValueError(
            "the CUDA PGHI recurrence does not cover n_fft=%d hop=%d (needs hop | n_fft "
            "and overlap >= 2)" % (n_fft, hop)
        )
    if not pghi_phases_available(n_fft, hop):
        raise NotImplementedError(
            "the CUDA PGHI recurrence takes at most %d bins; n_fft=%d has %d (ROADMAP Queue 2, K6)"
            % (MAX_BINS, n_fft, n_fft // 2 + 1)
        )


def _plan_arrays(B: int, T: int, n_bins: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan's scratch ``(src int16, off float32)``, each ``(B, T, Fp)``."""
    fp = _plan_row(n_bins)
    return (torch.empty((B, T, fp), dtype=torch.int16, device=device),
            torch.empty((B, T, fp), dtype=torch.float32, device=device))


def _launch_phases(m, ang, gamma, n_fft, hop, tolerance, bidir) -> torch.Tensor:
    """K's recurrence: the plan and the walk, one call of ``att_pghi_phases``
    on the current stream, the plan in scratch from the caching allocator."""
    _require_phases(n_fft, hop)
    B, T, n_bins = m.shape
    out = torch.empty_like(m)
    src, off = _plan_arrays(B, T, n_bins, m.device)
    abstol = _abstol(m, tolerance).contiguous()
    lib = _build.load_library()
    with torch.cuda.device(m.device):
        code = lib.att_pghi_phases(
            m.data_ptr(), ang.data_ptr(), abstol.data_ptr(), out.data_ptr(), src.data_ptr(), off.data_ptr(),
            B, T, n_bins, *_constants(gamma, n_fft, hop), int(bidir and T >= 4), *_phases_plan(n_bins, T),
            _stream(),
        )
    _build.check(code, "pghi_phases")
    launches["pghi_plan"] += 1
    launches["pghi_phases"] += 1
    return out


def pghi_plan(mag, gamma, n_fft, hop_length, tolerance=1e-2, bidir=False, angles=None):
    """K's plan alone (the recurrence's first launch): ``mag (B, T, F)`` and
    the silent bins' ``angles`` of its shape -> ``(src, off)``, each ``(B, T,
    Fp)``, ``Fp`` = F rounded up to 8 (int16 and float32, padded with ``(-1,
    0)``).  On a CPU tensor :func:`pghi_plan_reference`."""
    if not mag.is_cuda:
        return pghi_plan_reference(mag, gamma, n_fft, hop_length, tolerance, bidir, angles)
    _require_phases(n_fft, hop_length)
    m, _ = _as_btf(mag, n_fft)
    ang = _angles_for(m, angles, None)
    B, T, n_bins = m.shape
    src, off = _plan_arrays(B, T, n_bins, m.device)
    abstol = _abstol(m, tolerance).contiguous()
    lib = _build.load_library()
    with torch.cuda.device(m.device):
        code = lib.att_pghi_plan(
            m.data_ptr(), ang.data_ptr(), abstol.data_ptr(), src.data_ptr(), off.data_ptr(), B, T, n_bins,
            *_constants(gamma, n_fft, hop_length), int(bidir and T >= 4), _phases_plan(n_bins, T)[0], _stream(),
        )
    _build.check(code, "pghi_plan")
    launches["pghi_plan"] += 1
    return src, off


def pghi_walk(src: torch.Tensor, off: torch.Tensor, n_bins: int, bidir=False) -> torch.Tensor:
    """K's walk alone (the recurrence's second launch) over a plan from
    :func:`pghi_plan` -> phases ``(B, T, n_bins)``.  On a CPU tensor
    :func:`pghi_walk_reference`."""
    if not off.is_cuda:
        return pghi_walk_reference(src, off, n_bins, bidir)
    B, T, fp = off.shape
    src, off = src.contiguous(), off.contiguous()
    if (fp != _plan_row(n_bins) or src.dtype != torch.int16 or off.dtype != torch.float32
            or tuple(src.shape) != tuple(off.shape) or src.data_ptr() % 16 or off.data_ptr() % 16):
        raise ValueError("expected a plan of (B, T, %d) int16 sources and float32 offsets, 16-byte aligned"
                         % _plan_row(n_bins))
    out = torch.empty((B, T, n_bins), dtype=torch.float32, device=off.device)
    _, warps, slots = _phases_plan(n_bins, T)
    lib = _build.load_library()
    with torch.cuda.device(off.device):
        code = lib.att_pghi_walk(
            src.data_ptr(), off.data_ptr(), out.data_ptr(), B, T, n_bins,
            int(bidir and T >= 4), warps, slots, _stream(),
        )
    _build.check(code, "pghi_walk")
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
    route = synth_route(n_fft, hop)
    with torch.cuda.device(m.device):
        if route != "product":
            rows, teams = _synth_fft_plan(n_fft, hop)
            wsyn = irfft_window(window.to(m.device), n_fft, route == "smooth").contiguous()
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
    routes["pghi_synthesize:" + route] += 1
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
    DFT and overlap-add: an FFT a frame on the FFT and smooth routes, else one
    product, :func:`synth_route`; torch ISTFT conventions).  ``window`` is the
    synthesis window."""
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
