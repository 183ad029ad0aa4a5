"""Whole-session streaming kernels (twin of the JAX ``ops/pallas/stream_step.py``).

A chunked session of an ``[OverlapAdd, RealtimeSTFT-family]`` chain is one
to three kernel launches instead of a Python loop of small ops per chunk
(``streaming.py``).  The sessions:

* ``make_fused_forward_session`` (kernel R): encode, audio ``(..., L)`` ->
  complex frames ``(..., T, F)`` and the chain's final state.  Where
  ``frames_fft.fft_covers(n_fft)`` (a power of two from 64 to 4096) the
  encode and the magnitude encode take the FFT route
  (``csrc/fft_smem.cuh:frames_rfft``: the window and a twiddle table, no
  basis); where ``frames_fft.fft_covers_smooth7(n_fft)`` (even, ``2^a 3^b
  5^c 7^d``, 64 to 4096, no power of two: 1200, 960, 768, 1344, 896, ...)
  the smooth route, the same kernel on ``frames_rfft``'s mixed-radix
  instance (with its radix-7 stage where ``n_fft`` has a factor 7); every
  other ``n_fft`` the product route (the window-folded ``(Kn, F)`` basis).
  The encode's rule reads ``n_fft`` alone (:func:`session_route`);
* ``make_fused_roundtrip`` (L): the complex roundtrip, audio -> audio;
* ``make_fused_random_roundtrip`` (M): the ``random`` roundtrip (the
  reference's default realtime mode), ``|X|`` with the session's angles.
  L and M take the FFT route where ``fft_covers(n_fft)``
  (``csrc/fft_smem.cuh:frames_roundtrip``: each frame pair's forward and
  inverse FFT in one team's buffer, the frames overlap-added in class order;
  :func:`_roundtrip_plan`), the smooth route (its mixed-radix instance)
  where ``fft_covers_smooth(n_fft)``, or ``fft_covers_smooth7(n_fft)`` and
  the smooth block fits (its radix-7 instance; at 4032 with overlap 4, 6, 7
  and 8 it does not), the products elsewhere: the rule reads ``(n_fft,
  hop)``;
* ``make_fused_random_invert`` (P): the ``random`` decode, magnitudes
  ``(..., T, F)`` -> audio ``(..., T * hop)``.  P, S and O's projection
  synthesis take the FFT route where ``fft_covers(n_fft)``
  (``csrc/stream_step.cu:session_decode_fft_kernel``: ``frames_irfft`` of
  the input spectra, the roundtrips' synthesis; :func:`_decode_plan`), the
  smooth route (its mixed-radix instance) where ``fft_covers_smooth7(n_fft)``
  (its radix-7 instance where ``n_fft`` has a factor 7: 1344, 896, ...), the
  synthesis product elsewhere (1408 = 2^7 11, odd sizes, above 4096): the
  rule reads ``n_fft`` alone;
* ``make_fused_pghi_roundtrip`` (N): the phaseless RT-PGHI roundtrip, three
  launches: the magnitude encode (R's analysis with an ``|X|`` epilogue), the
  recurrence (``csrc/pghi.cu:rt_pghi_phases_kernel``, one block per session:
  producer warps plan each stage of frames from the magnitudes while chain
  warps walk the previous stage's frames in order; :func:`_rt_plan`), P's
  synthesis with the recurrence's phases;
* ``make_fused_pghi_invert`` (Q): the RT-PGHI decode, the last two of those;
* ``make_fused_magnitude_session``: the magnitude encode alone (the
  ``[.., Magnitude]`` chains' RT-PGHI roundtrip runs it, then Q);
* ``make_fused_complex_invert`` (S): the complex decode, spectra ``(..., T,
  F)`` -> audio, P's synthesis reading ``(re, im)`` as they are;
* ``make_fused_pghi_gl_roundtrip`` / ``make_fused_pghi_gl_invert`` (O): the
  ``pghi_gl`` roundtrip and decode, the RT-PGHI seed polished by
  ``gl_iterations`` pinned-context Griffin-Lim projections a chunk.  O is
  serial across chunks (a chunk's seed and pinned context are the previous
  chunk's polished phases), so its wrapper walks the chunks on the host, each
  over the whole batch: the recurrence seeded with the carries
  (``csrc/pghi.cu``, one launch), the polish (:func:`gl_polish`), then the
  commit and the carries in small tensor operations; P's synthesis of every
  committed frame ends the session.  The polish is one launch a chunk where
  :func:`_polish_plan` takes the grid (``gl_polish_fft_kernel``, its
  mixed-radix instance where ``fft_covers_smooth7(n_fft)``, with its radix-7
  stage where ``n_fft`` has a factor 7: a block per session runs all
  ``gl_iterations`` projections with the grid in shared memory,
  ``frames_irfft`` into an overlap-add signal in shared memory, then
  ``frames_rfft`` of the re-framed rows and ``atan2``; plain version
  :func:`gl_polish_reference`), elsewhere two launches a projection: P's
  kernel with the window divided by ``overlap``, then the analysis of the
  re-framed rows, ``atan2``, the kept rows left alone, on the route of
  :func:`session_route` (``"project"``, ``n_fft`` alone):
  ``gl_project_analysis_fft_kernel`` (the encode's FFT-route block,
  ``frames_rfft`` with the polish's pairs, a session's frames over several
  blocks; plan :func:`_encode_plan`) on the FFT and smooth routes, so that
  ``gl_iterations`` two-launch projections are the polish to the bit, and
  ``gl_project_analysis_kernel`` (the product, at most 40 frames) elsewhere
  (plain version :func:`gl_project_reference`, whose analysis half on the
  FFT and smooth routes is :func:`gl_project_analysis_reference`).  The
  roundtrip runs the magnitude encode first.

Why N is three launches and not one: the recurrence is serial per session, so
one fused launch would hold both ``O(n_fft F)`` products to one block per
session (64 blocks on 132 SMs at the headline shape).

The kernels (``csrc/stream_step.cu``) carry no state between chunks: a fresh
session's frame ``t`` is the slice ``[t hop, t hop + n_fft)`` of the signal
behind ``overlap - 1`` zero hops of initial ring (:func:`session_rows`), and
its output the overlap-add of all synthesis frames at hop stride, cut at
``T * hop`` samples.  The synthesis basis holds the synthesis window divided
by OverlapAdd's ``gain_compensation`` (the chunked loop divides after the
overlap-add: the two differ by rounding).  On a CUDA tensor each session
launches its kernel or raises; on a CPU tensor it runs the plain PyTorch
version beside it (``session_*_reference``: materialized frames; on the FFT
route ``frames_fft.frames_rfft_reference`` and, for L and M,
``frames_irfft_reference`` and ``overlap_add_classes`` in the kernels'
schedule (the decodes too), with ``smooth=True`` on the smooth route; elsewhere ``torch.matmul`` against the windowed bases, in float32,
and ``ops/framing.overlap_add``), which is also what the kernels are held
against on the card.

Gates.  ``fused_*_available`` keep the JAX package's structural conditions:
``OverlapAdd`` and a ``RealtimeSTFT``-family transform with the same ``(n_fft,
hop)``, ``hop | n_fft``, ``2 <= overlap <= 8``, ``hop | chunk`` and ``chunk >=
n_fft``; ``pghi_gl`` adds ``lookahead_frames <= T_c`` and ``0 < gl_context <=
T_c``.  The overlap-add layout is the JAX package's
(``pghi_kernel.ola_supported``) or any the session's kernels take, by their
own limits: ``hop % 4 == 0``, a block that fits shared memory, at most 4096
bins in the recurrence, and a polish grid that the polish's block holds, or
the two-launch projection's limits (P's decode; at most 40 polished frames a
chunk on the product route only: :func:`kernel_covers`).
So only a shape that neither covers (hop 250) streams through the generic
scan, as it does in the JAX package; a shape inside the JAX package's layouts
but outside the kernels' limits raises ``NotImplementedError`` on a CUDA
tensor and is never sent elsewhere.

RT-PGHI.  The recurrence is ``ops/pghi.py:pghi_scan(time_stencil="backward")``
per chunk with the chunk's own threshold (``tolerance`` times the chunk's
maximum, zero frames of a ragged last chunk included), the previous two
frames' magnitudes and the previous phase carried across the boundary: what
the generic scan's ``RealtimeSTFT.pghi_stream`` carries.  Like that scan, the
phase carry is re-wrapped at every chunk boundary to the angle of ``m e^{i
phi}`` of the last frame (the JAX kernel carries it unwrapped, ROADMAP Queue
3).  The magnitudes carried are the frames' own (the generic scan takes
``|m e^{i phi}|``, equal up to rounding).

Everything in a frame's fill but the phase carry comes from magnitudes: the
threshold, the anchors (the onset rule included), the time steps ``ct`` and,
for every bin, the source of its value (:func:`rt_fill_plan`): itself at an
anchor, the nearest anchor below or above (the nearer; a tie takes the one
below), a constant where the frame has no anchor (0) or the bin is silent
(its angle), and the segment sum of the frequency steps from that anchor to
the bin.  The serial chain is then ``phi_t[k] = (phi_{t-1}[src] +
ct[src]) + seg[k]`` a bin, and the re-wrap at chunk boundaries.  The
segment sums are segmented scans in a fixed order of float32 additions
(``pghi_kernel.fill_sources``, shared with K's offline recurrence: tiles of
128 bins, 4 a lane, Kogge-Stone over the lanes, the tiles' carry): local
sums, with no cancellation between numbers of the phases' size.  The plain version (:func:`rt_pghi_phases_reference`)
repeats the kernel's operations in order.

``pghi_gl``.  The chunk's ``T_c + lookahead`` frames (the pending ones
first) go through the recurrence as one chunk: one threshold over all of
them, the carries ``mag_buffer`` / ``phase_buffer`` as its history.  The
polished grid is ``[gl_context pinned frames; those frames]`` plus
``overlap - 1`` zero frames, so that P's synthesis of the padded grid is its
whole overlap-add.  The carries come from the committed frames only: the
magnitudes as they are (the generic scan takes ``|m e^{i phi}|``, equal up to
rounding), the wrapped angle of the last committed frame, the pinned context's
phases as polished (unwrapped where a frozen row keeps the seed), and the
trailing ``lookahead`` magnitudes.  The draws are ``batch_shape + (T_c +
lookahead, F)`` a chunk.

Angle draws.  The random sessions draw their angles chunk by chunk, each of
shape ``batch_shape + (T_c, F)``, from one ``torch.Generator`` through
``ops/pghi.py:random_angles``, in the order the generic chunk scan draws them
(:func:`session_angles`): with the same seeded generator on the same device
the kernel route and the generic scan see the same angles bit for bit.  No
generator means one seeded with 0 for the whole session.  ``angles=`` takes
them as an operand instead (the tests feed the JAX package's draws).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..fft import _dft_matrices, _idft_matrices, _tables
from ..framing import frame, overlap_add
from ..pghi import EPS, random_angles
from . import _build
from .frames_fft import (
    MAX_SMEM,
    TWO_BLOCKS_SMEM,
    class_plan,
    class_plan_smooth,
    fft_area_floats,
    fft_covers,
    fft_covers_smooth,
    fft_covers_smooth7,
    fft_max_teams,
    fft_smooth_max_teams,
    fft_twiddles,
    frames_irfft_reference,
    frames_rfft_reference,
    irfft_window,
    overlap_add_classes,
)
from .pghi_kernel import _constants, fill_sources, ola_supported

__all__ = [
    "fused_forward_session_available", "make_fused_forward_session",
    "fused_roundtrip_available", "make_fused_roundtrip",
    "fused_random_roundtrip_available", "make_fused_random_roundtrip",
    "fused_random_invert_available", "make_fused_random_invert",
    "fused_pghi_roundtrip_available", "make_fused_pghi_roundtrip", "make_fused_magnitude_session",
    "fused_pghi_invert_available", "make_fused_pghi_invert",
    "fused_complex_invert_available", "make_fused_complex_invert",
    "fused_pghi_gl_roundtrip_available", "make_fused_pghi_gl_roundtrip",
    "fused_pghi_gl_invert_available", "make_fused_pghi_gl_invert",
    "kernel_covers", "session_rows", "session_angles", "rt_pghi_phases", "gl_project", "gl_polish",
    "session_encode_reference", "session_roundtrip_reference", "session_decode_reference",
    "session_magnitude_reference", "rt_fill_plan", "rt_pghi_phases_reference",
    "session_complex_decode_reference",
    "gl_project_reference", "gl_project_analysis_reference", "gl_polish_reference",
    "session_pghi_gl_reference", "launches", "routes",
    "reset_launches", "session_route",
]

MAX_ROWS = 40                     # frames one block's analysis holds (8 warps x 5 rows)
RT_MAX_BINS = 4096                # bins the RT-PGHI recurrence takes
_RT_WARPS = 24                    # warps of the recurrence's block, at most
_RT_STAGE = 16                    # frames of a stage, at most (csrc/pghi.cu: kRtStage)
MAX_OVERLAP = 8
_KC = 32                          # staged contraction rows (dft_common.cuh, synth_ola.cuh)
_STAGE = 2 * 32 * 128             # floats of the staging area both phases share

#: kernel launches made by the wrappers of this module, by kernel
#: (``session_random_decode`` counts P's kernel, which is also the synthesis of
#: the RT-PGHI sessions; O's launches of it as the projection's synthesis count
#: as ``gl_project_synthesis``, the seeded recurrence as ``rt_pghi_seeded``, the
#: one-launch polish as ``gl_polish``, the two-launch projection's analysis on
#: any route as ``gl_project_analysis``)
launches: Dict[str, int] = {
    "session_encode": 0, "session_roundtrip": 0,
    "session_random_roundtrip": 0, "session_random_decode": 0,
    "session_magnitude": 0, "rt_pghi_phases": 0, "session_complex_decode": 0,
    "rt_pghi_seeded": 0, "gl_project_synthesis": 0, "gl_project_analysis": 0, "gl_polish": 0,
}
#: the encode's, the roundtrips', the decodes', the polish's and O's analysis's
#: launches by route, ``"<kernel>:fft"`` / ``"<kernel>:smooth"`` /
#: ``"<kernel>:product"`` (each also counts in ``launches``; the polish has no
#: product route: the two-launch projection takes the grids it refuses)
routes: Dict[str, int] = {
    "session_encode:fft": 0, "session_encode:smooth": 0, "session_encode:product": 0,
    "session_magnitude:fft": 0, "session_magnitude:smooth": 0, "session_magnitude:product": 0,
    "session_roundtrip:fft": 0, "session_roundtrip:smooth": 0, "session_roundtrip:product": 0,
    "session_random_roundtrip:fft": 0, "session_random_roundtrip:smooth": 0,
    "session_random_roundtrip:product": 0,
    "session_random_decode:fft": 0, "session_random_decode:smooth": 0, "session_random_decode:product": 0,
    "session_complex_decode:fft": 0, "session_complex_decode:smooth": 0, "session_complex_decode:product": 0,
    "gl_project_synthesis:fft": 0, "gl_project_synthesis:smooth": 0, "gl_project_synthesis:product": 0,
    "gl_polish:fft": 0, "gl_polish:smooth": 0,
    "gl_project_analysis:fft": 0, "gl_project_analysis:smooth": 0, "gl_project_analysis:product": 0,
}


def reset_launches() -> None:
    for d in (launches, routes):
        for k in d:
            d[k] = 0


# ------------------------------------------------------------------ gates
def _parts(chain):
    """``(oadd, rt)`` of a two-child ``[OverlapAdd, RealtimeSTFT-family]``
    chain, else None."""
    from ...transforms.base import ComposeAudioTransform
    from ...transforms.oadd import OverlapAdd
    from ...transforms.stft import RealtimeSTFT

    if not isinstance(chain, ComposeAudioTransform) or len(chain) != 2:
        return None
    oadd, rt = chain.transforms
    if not isinstance(oadd, OverlapAdd) or not isinstance(rt, RealtimeSTFT):
        return None
    return oadd, rt


def _gate(chain, chunk_size: int, kinds: Tuple[str, ...], rows: Optional[int] = None,
          ctx: Optional[int] = None) -> bool:
    """The structure every session kernel of this module covers: ``[OverlapAdd,
    RealtimeSTFT-family]`` with matching ``(n_fft, hop)``, ``hop | n_fft``, ``2
    <= overlap <= 8``, ``hop | chunk`` and ``chunk >= n_fft``; and an
    overlap-add layout that the JAX package supports
    (``pghi_kernel.ola_supported``) or that every kernel of ``kinds`` takes
    (:func:`kernel_covers`).  So a shape goes to the generic scan only where
    the JAX package streams it there and the port's kernels cannot take it
    either (hop 250); one inside the JAX package's layouts but beyond a
    kernel's limits raises at the launch."""
    parts = _parts(chain)
    if parts is None:
        return False
    oadd, rt = parts
    n_fft, hop = rt.n_fft, rt.hop_length
    return (
        oadd.n_fft == n_fft
        and oadd.hop_length == hop
        and n_fft % hop == 0
        and 2 <= n_fft // hop <= MAX_OVERLAP
        and chunk_size % hop == 0
        and chunk_size >= n_fft
        and (ola_supported(n_fft, hop) or all(kernel_covers(k, n_fft, hop, rows, ctx) for k in kinds))
    )


def fused_roundtrip_available(chain, chunk_size: int) -> bool:
    """Gate of the complex roundtrip session (kernel L)."""
    return _gate(chain, chunk_size, ("roundtrip",))


def fused_random_roundtrip_available(chain, chunk_size: int) -> bool:
    """Gate of the ``inversion_mode="random"`` roundtrip session (M): the same
    structure (random phases carry no per-chunk statistic)."""
    return _gate(chain, chunk_size, ("roundtrip",))


def fused_forward_session_available(chain, chunk_size: int) -> bool:
    """Gate of the encode session (R), also the 3-chain's magnitude encode."""
    return _gate(chain, chunk_size, ("encode",))


def _invert_chunk_size(chain, chunk_frames: int) -> Optional[int]:
    """``chunk_frames * hop`` for a recognized two-chain, else None: the
    invert gates are the roundtrip gates at that chunk."""
    parts = _parts(chain)
    return None if parts is None else chunk_frames * parts[1].hop_length


def fused_random_invert_available(chain, chunk_frames: int) -> bool:
    """Gate of the ``inversion_mode="random"`` decode session (P)."""
    cs = _invert_chunk_size(chain, chunk_frames)
    return cs is not None and _gate(chain, cs, ("decode",))


def fused_pghi_roundtrip_available(chain, chunk_size: int) -> bool:
    """Gate of the ``inversion_mode="pghi"`` roundtrip session (the magnitude
    encode, N, P): the same structure (the integer overlap and the window's
    ``gamma`` PGHI needs are in it: ``hop | n_fft``, and every
    ``RealtimeSTFT`` has a gamma).  The threshold is a chunk statistic, so the
    chunk is a parameter of the recurrence, not a tiling."""
    return _gate(chain, chunk_size, ("encode", "recurrence", "decode"))


def fused_pghi_invert_available(chain, chunk_frames: int) -> bool:
    """Gate of the ``inversion_mode="pghi"`` decode session (Q: N's
    recurrence, P)."""
    cs = _invert_chunk_size(chain, chunk_frames)
    return cs is not None and _gate(chain, cs, ("recurrence", "decode"))


def fused_complex_invert_available(chain, chunk_frames: int) -> bool:
    """Gate of the complex (explicit-phase) decode session (S)."""
    cs = _invert_chunk_size(chain, chunk_frames)
    return cs is not None and _gate(chain, cs, ("decode",))


def _gl_gate(chain, chunk_size: int, kinds: Tuple[str, ...]) -> bool:
    parts = _parts(chain)
    if parts is None:
        return False
    rt = parts[1]
    T_c = chunk_size // rt.hop_length
    la = int(rt.lookahead_frames)
    ctx = int(rt.gl_context)
    return (0 <= la <= T_c and 0 < ctx <= T_c
            and _gate(chain, chunk_size, kinds + ("project",), T_c + la, ctx))


def fused_pghi_gl_roundtrip_available(chain, chunk_size: int) -> bool:
    """Gate of the ``inversion_mode="pghi_gl"`` roundtrip session (the
    magnitude encode, O, P): the ``pghi`` structure, ``0 <= lookahead_frames
    <= T_c`` and ``0 < gl_context <= T_c`` (the JAX gate's ``hop % 128`` lane
    condition gives way to the kernels' own limits, :func:`kernel_covers`)."""
    return _gl_gate(chain, chunk_size, ("encode", "recurrence", "decode"))


def fused_pghi_gl_invert_available(chain, chunk_frames: int) -> bool:
    """Gate of the ``inversion_mode="pghi_gl"`` decode session (O, P)."""
    cs = _invert_chunk_size(chain, chunk_frames)
    return cs is not None and _gl_gate(chain, cs, ("recurrence", "decode"))


# ------------------------------------------------------- kernels' limits
def _k_padded(n_bins: int) -> int:
    """Row length of the synthesis's ``[re | im]`` rows: 2F rounded up to 32."""
    return -(-2 * n_bins // _KC) * _KC


def _k_analysis(n_fft: int) -> int:
    """Rows of the analysis basis: n_fft rounded up to 32 (zero rows below)."""
    return -(-n_fft // _KC) * _KC


def _encode_smem_bytes(rows: int, hop: int, kn: int) -> int:
    """Shared memory of one encode block on the product route, as
    ``csrc/stream_step.cu`` lays it out."""
    return 4 * ((rows - 1) * hop + kn + _STAGE)


SESSION_ROUTE_KINDS = ("encode", "roundtrip", "decode", "polish", "project")


def session_route(n_fft: int, kind: str, hop: Optional[int] = None) -> str:
    """The route of the session kernel ``kind`` at ``n_fft``: ``"fft"`` where
    ``fft_covers`` (a power of two from 64 to 4096), ``"smooth"`` where
    ``fft_covers_smooth7`` (the mixed-radix instance, with its radix-7 stage
    where ``n_fft`` has a factor 7), else ``"product"``.  The encodes
    (``"encode"``: R and the magnitude encode), the decodes (``"decode"``:
    P, S, O's projection synthesis, so N's and Q's synthesis), O's polish
    (``"polish"``, where :func:`_polish_plan` holds the grid: it has no
    product route) and O's two-launch analysis (``"project"``) read ``n_fft``
    alone: every block of theirs fits.  The roundtrips (``"roundtrip"``: L
    and M) take the radix-7 instance only where the smooth block fits at
    ``hop`` (at 4032 with overlap 4, 6, 7 and 8 it does not, the product
    block does).  Every caller names its kind."""
    if kind not in SESSION_ROUTE_KINDS:
        raise ValueError("session_route: kind %r is none of %s" % (kind, SESSION_ROUTE_KINDS))
    if fft_covers(n_fft):
        return "fft"
    if fft_covers_smooth(n_fft):
        return "smooth"
    if fft_covers_smooth7(n_fft):
        if kind != "roundtrip":
            return "smooth"
        if hop is None:
            raise ValueError("the roundtrip's route at n_fft=%d reads the hop" % int(n_fft))
        if _roundtrip_fft_plan(int(n_fft), int(hop), True) is not None:
            return "smooth"
    return "product"



def _encode_fft_smem_bytes(rows: int, hop: int, n_fft: int, teams: int) -> int:
    """Shared memory of one encode block on the FFT or smooth route: the
    samples of ``rows`` frames, then ``frames_rfft``'s window, twiddles and
    buffers."""
    return 4 * ((rows - 1) * hop + n_fft + fft_area_floats(n_fft, teams))


def _roundtrip_smem_bytes(rows: int, overlap: int, hop: int, kn: int, kp: int) -> int:
    n_rows = rows + overlap - 1
    return 4 * ((n_rows - 1) * hop + kn + n_rows * kp + _STAGE)


def _roundtrip_fft_smem_bytes(rows: int, overlap: int, hop: int, teams: int) -> int:
    """Shared memory of one roundtrip block on the FFT or smooth route: the
    samples of ``rows + 2 overlap`` frames, the ``rows`` output chunks,
    ``frames_rfft``'s area and the synthesis window."""
    n = overlap * hop
    return 4 * ((rows + 2 * overlap - 1) * hop + n + rows * hop + fft_area_floats(n, teams) + n)


def _decode_smem_bytes(rows: int, overlap: int, kp: int) -> int:
    return 4 * ((rows + overlap - 1) * kp + _STAGE)


def _decode_fft_smem_bytes(rows: int, hop: int, n_fft: int, teams: int) -> int:
    """Shared memory of one decode block on the FFT or smooth route: the
    ``rows`` output chunks and ``frames_irfft``'s area on the route ``n_fft``
    takes (the synthesis window in the window's place)."""
    return 4 * (rows * hop + fft_area_floats(n_fft, teams))


def _best_rows(candidates, overlap: int) -> Optional[int]:
    """The block height with the least recomputed or idle work: a block of R
    output chunks analyses or builds R + overlap - 1 frame rows, and the
    synthesis computes 8 * ceil(R / 8) chunks."""
    best, score = None, 0.0
    for r in candidates:
        s = r / (8 * -(-r // 8)) * r / (r + overlap - 1)
        if s > score:
            best, score = r, s
    return best


@functools.lru_cache(maxsize=None)
def _pick_rows(kind: str, n_fft: int, hop: int) -> Optional[int]:
    """Frames (encode) or output chunks (roundtrip, decode) per block, or
    None when not even one fits shared memory."""
    overlap = n_fft // hop
    kp, kn = _k_padded(n_fft // 2 + 1), _k_analysis(n_fft)
    if kind == "encode":
        fit = [r for r in range(1, MAX_ROWS + 1) if _encode_smem_bytes(r, hop, kn) <= MAX_SMEM]
        return max(fit) if fit else None
    if kind == "roundtrip":
        fit = [r for r in range(1, MAX_ROWS - overlap + 2)
               if _roundtrip_smem_bytes(r, overlap, hop, kn, kp) <= MAX_SMEM]
    else:
        fit = [r for r in range(1, MAX_ROWS + 1) if _decode_smem_bytes(r, overlap, kp) <= MAX_SMEM]
    return _best_rows(fit, overlap)


@functools.lru_cache(maxsize=None)
def _encode_plan(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(rows, teams)`` of the encode's launch, or None when no block fits.
    The FFT route (``fft_covers(n_fft)``): as many FFTs side by side as 256
    threads run (``4096 / n_fft``), and a block of four rounds of them (8
    frames per FFT: measured fastest at 1024/256 among 1, 2, 4 and 8 rounds,
    two blocks to an SM), fewer rounds and then fewer FFTs where that does
    not fit; the smooth route (``fft_covers_smooth7(n_fft)``) the same rule
    with its own teams (``frames_fft.fft_smooth_max_teams``: 2 at 1200 and
    1344, 16 frames; 4 at 896, 32 frames), first among the blocks that leave
    room for a second on the SM (measured on the H100 at 1920/480: 8 frames
    two blocks an SM 0.24 ms, 16 one block 0.35); the product route: ``teams
    = 0`` and :func:`_pick_rows`'s height.  O's two-launch analysis takes
    this plan on the FFT and smooth routes (its block is the encode's)."""
    route = session_route(n_fft, "encode")
    if route == "product":
        rows = _pick_rows("encode", n_fft, hop)
        return None if rows is None else (rows, 0)
    if route == "smooth":
        limits = (TWO_BLOCKS_SMEM, MAX_SMEM)
        top = fft_smooth_max_teams(n_fft)
    else:
        limits, top = (MAX_SMEM,), fft_max_teams(n_fft)
    for limit in limits:
        teams = top
        while teams >= 1:
            rows = 8 * teams
            while rows >= 2:
                if _encode_fft_smem_bytes(rows, hop, n_fft, teams) <= limit:
                    return rows, teams
                rows //= 2
            teams //= 2
    return None


@functools.lru_cache(maxsize=None)
def _roundtrip_plan(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(rows, teams)`` of L's and M's launch, or None when no block fits.
    The FFT route (``fft_covers(n_fft)``): ``frames_fft.class_plan`` (rows a
    multiple of ``2 overlap``, two blocks an SM where they fit: 24 chunks and 4
    FFTs at 1024/256); the smooth route (:func:`session_route`'s:
    ``fft_covers_smooth(n_fft)``, or ``fft_covers_smooth7(n_fft)`` where the
    block fits) ``frames_fft.class_plan_smooth`` (16 chunks and 2 FFTs at
    1200/300, 56 and 4 at 960/240); the product route: ``teams = 0`` and
    :func:`_pick_rows`'s height."""
    route = session_route(n_fft, "roundtrip", hop)
    if route == "product":
        rows = _pick_rows("roundtrip", n_fft, hop)
        return None if rows is None else (rows, 0)
    return _roundtrip_fft_plan(n_fft, hop, route == "smooth")


@functools.lru_cache(maxsize=None)
def _roundtrip_fft_plan(n_fft: int, hop: int, smooth: bool) -> Optional[Tuple[int, int]]:
    """``(rows, teams)`` of L's and M's block on the FFT route
    (``frames_fft.class_plan``) or the smooth route
    (``frames_fft.class_plan_smooth``), or None where none fits."""
    overlap = n_fft // hop
    plan = class_plan_smooth if smooth else class_plan
    return plan(n_fft, hop, lambda r, teams: _roundtrip_fft_smem_bytes(r, overlap, hop, teams))


#: blocks an SM the decode's radix-7 instance
#: (``session_decode_fft_kernel<., true, true>``) runs at the registers its
#: build takes: 256 threads, 65536 registers an SM
DECODE_SEVEN_BLOCKS = 3


@functools.lru_cache(maxsize=None)
def _decode_plan(n_fft: int, hop: int, rows: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """``(rows, teams)`` of the decode's launch (P, S, O's projection
    synthesis), or None when no block fits.  The FFT route
    (``fft_covers(n_fft)``): rows a multiple of ``2 overlap``,
    ``frames_fft.class_plan``'s (56 chunks, 4 FFTs at 1024/256, two blocks an
    SM); the smooth route (``fft_covers_smooth(n_fft)``)
    ``frames_fft.class_plan_smooth``'s with up to four blocks an SM (its
    instance takes 64 registers: 40 chunks of 2 FFTs at 1200/300, 24 of 4 at
    960/240 and 768/192, the fastest of a sweep of every plan on an H100),
    and its radix-7 instance (``fft_covers_smooth7(n_fft)``, a factor 7)
    with up to :data:`DECODE_SEVEN_BLOCKS` (what its registers allow);
    for narrow blocks on either (``rows`` given: O's projection, so that one
    session's grid spreads over several SMs) the smallest multiple of ``2
    overlap`` at least ``rows`` (8 chunks at 1024/256 and 1200/300), with as
    many FFTs side by side as fit; the product route: ``teams = 0`` and
    :func:`_pick_rows`'s height (at most ``rows``)."""
    route = session_route(n_fft, "decode")
    if route == "product":
        fit = _pick_rows("decode", n_fft, hop)
        if fit is None:
            return None
        return (fit if rows is None else min(int(rows), fit)), 0
    overlap = n_fft // hop

    def smem(r, teams):
        return _decode_fft_smem_bytes(r, hop, n_fft, teams)

    if rows is None:
        if route == "fft":
            return class_plan(n_fft, hop, smem, widest=max(64, 2 * overlap))
        blocks = DECODE_SEVEN_BLOCKS if n_fft % 7 == 0 else 4
        return class_plan_smooth(n_fft, hop, smem, widest=max(64, 2 * overlap), blocks=blocks)
    r = -(-int(rows) // (2 * overlap)) * 2 * overlap
    teams = fft_max_teams(n_fft) if route == "fft" else fft_smooth_max_teams(n_fft)
    while teams >= 1:
        if smem(r, teams) <= MAX_SMEM:
            return r, teams
        teams //= 2
    return None


def _project_frames_fit(n_fft: int, hop: int, rows: int) -> bool:
    """Whether O's projection analysis takes a grid of ``rows`` polished
    frames (``T_c + lookahead``): on the FFT and smooth routes any number
    (:func:`_encode_plan`'s blocks of an even group of frames); on the product
    route at most 40, whose samples fit one block's shared memory."""
    if session_route(n_fft, "project") != "product":
        return rows >= 1 and _encode_plan(n_fft, hop) is not None
    return 1 <= rows <= MAX_ROWS and _encode_smem_bytes(rows, hop, _k_analysis(n_fft)) <= MAX_SMEM


def _two_launch_covers(n_fft: int, hop: int, rows: int) -> bool:
    """Whether the two-launch projection (P's synthesis in narrow blocks,
    then the analysis) takes ``rows`` polished frames."""
    return (kernel_covers("decode", n_fft, hop) and _decode_plan(n_fft, hop, PROJECT_SYN_ROWS) is not None
            and _project_frames_fit(n_fft, hop, int(rows)))


def _polish_smem_bytes(Tp: int, hop: int, n_fft: int, teams: int, resident: bool) -> int:
    """Shared memory of one block of the polish (``gl_polish_fft_kernel``),
    as ``csrc/stream_step.cu:polish_smem_floats`` lays it out: the grid's
    overlap-add signal (``Tp hop``), ``frames_rfft``'s area on the route
    ``n_fft`` takes (``frames_fft.fft_area_floats``), the synthesis window,
    and where ``resident`` the grid's magnitudes and phases."""
    n_bins = n_fft // 2 + 1
    return 4 * (Tp * hop + fft_area_floats(n_fft, teams) + n_fft + (2 * Tp * n_bins if resident else 0))


@functools.lru_cache(maxsize=None)
def _polish_plan(n_fft: int, hop: int, Tp: int) -> Optional[Tuple[int, bool]]:
    """``(teams, resident)`` of the polish's launch for a grid of ``Tp``
    frames (``gl_context + T_c + lookahead + overlap - 1``), or None, and then
    the polish is ``gl_iterations`` two-launch projections.  It takes ``n_fft``
    a power of two from 64 to 4096 (``fft_covers``) or even and ``2^a 3^b 5^c
    7^d`` (``fft_covers_smooth7``: the kernel's mixed-radix instance, its
    radix-7 one where ``n_fft`` has a factor 7, the route of
    :func:`session_route`), ``hop % 4 == 0``, ``2 <= overlap <= 8`` and a
    block that fits shared memory: the grid's magnitudes and phases in shared
    memory (``resident``) with the most FFTs side by side that fit (``4096 /
    n_fft`` on 256 threads on the FFT route: 4 at 1024/256, a 160 KB block at
    22 frames; ``frames_fft.fft_smooth_max_teams`` on the smooth route: 2 at
    1200/300, a 137 KB block at 14 frames; 2 at 1344/336), else read from and
    written to device memory.  The rule reads the shape alone, never a failed
    launch."""
    ov = n_fft // hop if hop else 0
    route = session_route(n_fft, "polish")
    if route == "product" or hop % 4 or n_fft % hop or not 2 <= ov <= MAX_OVERLAP or Tp < ov:
        return None
    for resident in (True, False):
        teams = fft_max_teams(n_fft) if route == "fft" else fft_smooth_max_teams(n_fft)
        while teams >= 1:
            if _polish_smem_bytes(Tp, hop, n_fft, teams, resident) <= MAX_SMEM:
                return teams, resident
            teams //= 2
    return None


def kernel_covers(kind: str, n_fft: int, hop: int, rows: Optional[int] = None,
                  ctx: Optional[int] = None) -> bool:
    """Whether the kernel of ``kind`` takes the shape: ``"encode"`` (R and the
    magnitude encode), ``"roundtrip"`` (L, M) and ``"decode"`` (P, S) need
    ``hop % 4 == 0`` (16-byte rows) and a block that fits shared memory;
    ``"recurrence"`` (RT-PGHI) at most 4096 bins, what one block holds;
    ``"project"`` (O's polish) a grid of ``ctx + rows + overlap - 1`` frames
    that :func:`_polish_plan` takes (``rows = T_c + lookahead``; ``ctx``, the
    pinned context, at most ``rows``: None counts it as ``rows``), or the
    two-launch projection's limits: P's, and on the product route at most 40
    polished frames whose samples fit shared memory."""
    if kind == "recurrence":
        return n_fft % hop == 0 and n_fft // 2 + 1 <= RT_MAX_BINS
    if kind == "project":
        rows = int(rows)
        tp = (rows if ctx is None else int(ctx)) + rows + n_fft // hop - 1
        return _polish_plan(n_fft, hop, tp) is not None or _two_launch_covers(n_fft, hop, rows)
    if kind == "encode":
        return hop % 4 == 0 and n_fft % hop == 0 and _encode_plan(n_fft, hop) is not None
    if kind == "decode":
        return hop % 4 == 0 and n_fft % hop == 0 and _decode_plan(n_fft, hop) is not None
    return hop % 4 == 0 and n_fft % hop == 0 and _pick_rows(kind, n_fft, hop) is not None


_PROJECT_NEED = ("hop % 4 == 0 and a grid (gl_context + T_c + lookahead + overlap - 1 frames) that the "
                 "polish's block holds in shared memory at n_fft a power of two from 64 to 4096 or an even "
                 "2^a 3^b 5^c 7^d, or P's limits and, at any other n_fft, at most 40 polished frames "
                 "(T_c + lookahead) whose samples fit shared memory")


def _require(kind: str, n_fft: int, hop: int, rows: Optional[int] = None,
             ctx: Optional[int] = None) -> Optional[int]:
    """The block height of ``kind`` (None for the recurrence and the
    projection; for the encode, the product route's: the FFT route's plan is
    :func:`_encode_plan`'s), or raise: a shape the structural gate lets
    through is never quietly computed some other way."""
    if kernel_covers(kind, n_fft, hop, rows, ctx):
        return None if kind in ("recurrence", "project") else _pick_rows(kind, n_fft, hop)
    need = {"recurrence": "at most 4096 bins", "project": _PROJECT_NEED}.get(
        kind, "hop % 4 == 0 and a block that fits shared memory")
    raise NotImplementedError(
        "the CUDA session kernels do not cover n_fft=%d hop=%d (%s): they need "
        "%s (ROADMAP Queue 2, K10-K17); use backend='generic'" % (n_fft, hop, kind, need)
    )


# ------------------------------------------------------- shared plumbing
def session_rows(x2d: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """The row-padded signal ``(B, (n_frames + overlap - 1) * hop)``:
    ``overlap - 1`` zero hops of initial ring, the signal, zeros to the end.
    Frame ``t`` of the session is its slice ``[t hop, t hop + n_fft)``."""
    lead = n_fft - hop
    total = (n_frames - 1) * hop + n_fft
    tail = total - lead - x2d.shape[-1]
    return torch.nn.functional.pad(x2d, (lead, tail))


def session_angles(batch_shape, n_chunks: int, T_c: int, n_bins: int, device,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The session's phases ``(B, n_chunks * T_c, F)``, drawn chunk by chunk
    as the generic scan draws them (one ``batch_shape + (T_c, F)`` draw per
    chunk from ``generator``; None: one seeded with 0)."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    shape = tuple(batch_shape) + (T_c, n_bins)
    draws = [random_angles(shape, device, generator) for _ in range(n_chunks)]
    return torch.cat(draws, dim=-2).reshape(-1, n_chunks * T_c, n_bins)


def _ana_basis(window: torch.Tensor, n_fft: int, rows: Optional[int] = None):
    """``w[n] (cos, -sin)(2 pi n k / n_fft)`` as two ``(rows, F)`` tensors,
    zero rows past n_fft."""
    C, S = _tables(_dft_matrices, window.device, n_fft)
    w = window.to(torch.float32)[:, None]
    pad = (0, 0, 0, (rows or n_fft) - n_fft)
    return (torch.nn.functional.pad(w * C, pad).contiguous(),
            torch.nn.functional.pad(w * S, pad).contiguous())


def _encode_operands(window: torch.Tensor, n_fft: int):
    """What the encode reads besides the signal: on the FFT and smooth routes
    the window ``(n_fft,)`` and the twiddle table ``(2, n_fft)``, on the
    product route the window-folded basis ``(Kn, F)`` x 2."""
    if session_route(n_fft, "encode") != "product":
        (tw,) = _tables(fft_twiddles, window.device, n_fft)
        return window.to(torch.float32).contiguous(), tw
    return _ana_basis(window, n_fft, _k_analysis(n_fft))


def _syn_mats(inv_window: torch.Tensor, gain: float, n_fft: int):
    """Inverse real-DFT matrices ``(F, n_fft)`` with ``inv_window / gain``
    folded in."""
    A, Bm = _tables(_idft_matrices, inv_window.device, n_fft)
    w = (inv_window.to(torch.float32) / gain)[None, :]
    return A * w, Bm * w


def _syn_basis(inv_window: torch.Tensor, gain: float, n_fft: int, hop: int) -> torch.Tensor:
    """The kernels' synthesis basis ``(overlap, Kp, hop)``: rows ``[A; B; 0]``
    of :func:`_syn_mats`, cut into ``overlap`` pieces of ``hop`` samples."""
    n_bins = n_fft // 2 + 1
    kp = _k_padded(n_bins)
    Aw, Bw = _syn_mats(inv_window, gain, n_fft)
    ab = torch.cat([Aw, Bw, Aw.new_zeros((kp - 2 * n_bins, n_fft))], dim=0)
    return ab.reshape(kp, n_fft // hop, hop).permute(1, 0, 2).contiguous()


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1, x.shape[-1])).to(torch.float32).contiguous()


def _angles_3d(angles: torch.Tensor, B: int, n_frames: int, n_bins: int, device) -> torch.Tensor:
    a = angles.to(device=device, dtype=torch.float32).reshape(B, -1, n_bins)
    if a.shape[1] < n_frames:
        raise ValueError("angles hold %d frames, the session needs %d" % (a.shape[1], n_frames))
    return a.contiguous()


# ---------------------------------------------------------- plain versions
def session_encode_reference(x2d, window, n_fft: int, hop: int, n_frames: int):
    """Plain version of kernel R: ``(re, im)`` of the session's ``n_frames``
    frames, each ``(B, n_frames, F)``: ``frames_rfft_reference`` on the FFT
    and smooth routes (their schedules), else the products with the
    window-folded basis."""
    frames = frame(session_rows(x2d, n_fft, hop, n_frames), n_fft, hop)
    route = session_route(n_fft, "encode")
    if route != "product":
        return frames_rfft_reference(frames, window.to(x2d.device), smooth=route == "smooth")
    WC, WS = _ana_basis(window.to(x2d.device), n_fft)
    return torch.matmul(frames, WC), torch.matmul(frames, WS)


def _decode_operands(inv_window: torch.Tensor, gain: float, n_fft: int, hop: int):
    """What the decode reads besides the spectra, ``(syn, wsyn, twiddles)``:
    on the FFT and smooth routes (the radix-7 instance's too) the synthesis
    window over the gain and ``n_fft`` (``frames_fft.irfft_window``, the
    smooth route's fold a float64 division rounded once) and the twiddle
    table, on the product route the basis of :func:`_syn_basis`."""
    route = session_route(n_fft, "decode")
    if route != "product":
        (tw,) = _tables(fft_twiddles, inv_window.device, n_fft)
        wsyn = irfft_window(inv_window.to(torch.float32) / gain, n_fft, route == "smooth")
        return None, wsyn.contiguous(), tw
    return _syn_basis(inv_window, gain, n_fft, hop), None, None


def _synthesize(re, im, inv_window, gain: float, n_fft: int, hop: int, T: int) -> torch.Tensor:
    Aw, Bw = _syn_mats(inv_window.to(re.device), gain, n_fft)
    frames = torch.matmul(re, Aw) + torch.matmul(im, Bw)
    return overlap_add(frames, hop)[..., : T * hop]


def _synthesize_fft(re, im, inv_window, gain: float, n_fft: int, hop: int, T: int,
                    smooth: bool = False) -> torch.Tensor:
    """The synthesis of the FFT route in its kernels' schedule (the decode's
    and the roundtrips'): the frames from ``-(overlap - 1)`` on (those before
    0 zero), paired ``(u, u + overlap)`` for ``u mod 2 overlap < overlap``
    counted from the first, through ``frames_irfft_reference`` under the
    synthesis window over the gain; the samples of the frames before 0
    dropped, the overlap-add in class order ``(f + overlap - 1) mod
    overlap``, cut at ``T * hop``.  ``smooth``: the smooth route (the
    mixed-radix schedule, with its radix-7 stage where ``n_fft`` has a
    factor 7)."""
    m = n_fft // hop - 1
    lead = re.new_zeros(re.shape[:-2] + (m, re.shape[-1]))
    wsyn = irfft_window(inv_window.to(device=re.device, dtype=torch.float32) / gain, n_fft, smooth)
    y = frames_irfft_reference(torch.cat([lead, re], dim=-2), torch.cat([lead, im], dim=-2), wsyn,
                               n_fft // hop, smooth)[..., m:, :]
    return overlap_add_classes(y, hop, m)[..., : T * hop]


def _synthesis_reference(re, im, inv_window, gain: float, n_fft: int, hop: int, T: int) -> torch.Tensor:
    """The plain synthesis of the route ``n_fft`` picks (:func:`session_route`):
    :func:`_synthesize_fft` on the FFT and smooth routes (``smooth=True`` on
    the latter: the mixed-radix schedule, its radix-7 stage where ``n_fft``
    has a factor 7), else :func:`_synthesize`."""
    route = session_route(n_fft, "decode")
    if route == "product":
        return _synthesize(re, im, inv_window, gain, n_fft, hop, T)
    return _synthesize_fft(re, im, inv_window, gain, n_fft, hop, T, route == "smooth")


def session_roundtrip_reference(x2d, window, inv_window, gain: float, n_fft: int, hop: int,
                                n_frames: int, angles=None) -> torch.Tensor:
    """Plain version of kernels L (``angles=None``) and M: ``(B, n_frames *
    hop)``; M's angles ``(B, >= n_frames, F)``.  On the FFT and smooth routes
    it repeats their schedule (:func:`_roundtrip_fft_reference`), elsewhere
    the window-folded analysis product and the synthesis.  The route is the
    roundtrip's own (:func:`session_route` at ``(n_fft, hop)``): at 4032 with
    overlap 4, 6, 7 or 8 the encode takes the smooth route and this the
    products."""
    route = session_route(n_fft, "roundtrip", hop)
    if route != "product":
        return _roundtrip_fft_reference(x2d, window, inv_window, gain, n_fft, hop, n_frames, angles,
                                        smooth=route == "smooth")
    frames = frame(session_rows(x2d, n_fft, hop, n_frames), n_fft, hop)
    WC, WS = _ana_basis(window.to(x2d.device), n_fft)
    re, im = torch.matmul(frames, WC), torch.matmul(frames, WS)
    if angles is not None:
        a = angles[:, :n_frames]
        mag = torch.sqrt(re * re + im * im)
        re, im = mag * torch.cos(a), mag * torch.sin(a)
    return _synthesize(re, im, inv_window, gain, n_fft, hop, n_frames)


def _roundtrip_fft_reference(x2d, window, inv_window, gain, n_fft, hop, T, angles=None, smooth=False):
    """L and M on the FFT route (``smooth``: the smooth route's mixed-radix
    schedule), in the kernel's schedule: the frames from
    ``-(overlap - 1)`` on (those before 0 all zero), paired ``(u, u +
    overlap)`` for ``u mod 2 overlap < overlap`` counted from the first, through
    ``frames_rfft_reference`` and ``frames_irfft_reference`` with that stride;
    the bins of the frames before 0 zero (M: ``|X| (cos, sin)(angle)`` of the
    others) and their samples dropped; the overlap-add in class order ``(f +
    overlap - 1) mod overlap``, cut at ``T * hop``."""
    ov = n_fft // hop
    m = ov - 1
    frames = frame(session_rows(x2d, n_fft, hop, T), n_fft, hop)
    frames = torch.cat([frames.new_zeros((frames.shape[0], m, n_fft)), frames], dim=1)
    re, im = frames_rfft_reference(frames, window.to(x2d.device), ov, smooth)
    re, im = re[:, m:], im[:, m:]
    if angles is not None:
        a = angles[:, :T]
        mag = torch.sqrt(re * re + im * im)
        re, im = mag * torch.cos(a), mag * torch.sin(a)
    return _synthesize_fft(re, im, inv_window, gain, n_fft, hop, T, smooth)


def session_decode_reference(mag, angles, inv_window, gain: float, n_fft: int, hop: int) -> torch.Tensor:
    """Plain version of kernel P: magnitudes ``(B, T, F)`` and angles ``(B,
    >= T, F)`` -> ``(B, T * hop)``, on the route ``n_fft`` picks
    (:func:`_synthesis_reference`)."""
    T = mag.shape[1]
    a = angles[:, :T]
    return _synthesis_reference(mag * torch.cos(a), mag * torch.sin(a), inv_window, gain, n_fft, hop, T)


def session_complex_decode_reference(spec, inv_window, gain: float, n_fft: int, hop: int) -> torch.Tensor:
    """Plain version of kernel S: a complex spectrum ``(B, T, F)`` -> ``(B, T *
    hop)``, on the route ``n_fft`` picks (the imaginary parts at DC and
    nyquist unread on both)."""
    return _synthesis_reference(spec.real.contiguous(), spec.imag.contiguous(), inv_window, gain, n_fft, hop,
                                spec.shape[1])


def session_magnitude_reference(x2d, window, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Plain version of the magnitude encode: ``|X|`` ``(B, n_frames, F)`` of
    R's frames, ``sqrt(re * re + im * im)``."""
    re, im = session_encode_reference(x2d, window, n_fft, hop, n_frames)
    return torch.sqrt(re * re + im * im)


def rt_fill_plan(mag, angles, gamma: float, n_fft: int, hop: int, tolerance: float, chunk_frames: int,
                 prev_mag=None):
    """The magnitude-only part of the RT-PGHI recurrence, for every frame at
    once (module notes): ``mag (B, T, F)``, ``T`` a multiple of
    ``chunk_frames``, and the silent bins' angles ``(B, >= T, F)`` -> ``(src,
    ct, seg)``, each ``(B, T, F)``: a bin takes ``(phi[src] + ct[src]) +
    seg`` of the previous frame's phases ``phi`` where ``src >= 0``, else
    the constant ``seg``.  Frame ``t``'s two previous frames are the
    session's own (before the first: ``prev_mag (B, 2, F)``, or two zero
    frames); chunk ``c``'s threshold is ``max(tolerance * max(mag[c]),
    EPS)``."""
    B, T, n_bins = mag.shape
    T_c = int(chunk_frames)
    if T % T_c:
        raise ValueError("%d frames are no whole number of %d-frame chunks" % (T, T_c))
    dev, dt = mag.device, torch.float32
    fmul, inv_fmul, carrier = _constants(gamma, n_fft, hop)
    prev = mag.new_zeros((B, 2, n_bins)) if prev_mag is None else prev_mag.to(dt)
    mz = torch.cat([prev, mag], dim=1)
    Yz = torch.log(torch.clamp_min(mz, EPS))
    ck = carrier * torch.arange(n_bins, device=dev, dtype=dt)
    up = torch.cat([Yz[..., 1:], Yz[..., -1:]], dim=-1)
    dn = torch.cat([Yz[..., :1], Yz[..., :-1]], dim=-1)
    ts = ((up - dn) * 0.5) * inv_fmul + ck                  # (B, T + 2, F)
    ct = (ts[:, 1:-1] + ts[:, 2:]) * 0.5
    Y, Y1, Y2 = Yz[:, 2:], Yz[:, 1:-1], Yz[:, :-2]
    fs = (-fmul) * (((3.0 * Y - 4.0 * Y1) + Y2) * 0.5) + math.pi
    del Yz, up, dn, ts, Y, Y1, Y2
    mx = mag.reshape(B, T // T_c, T_c * n_bins).amax(dim=-1)
    thr = torch.clamp_min(tolerance * mx, EPS).repeat_interleave(T_c, dim=1)[..., None]
    sig = mag > thr
    mpad = torch.nn.functional.pad(mag, (1, 1), value=-1.0)
    peak = sig & (mz[:, 1:-1] > thr) & (mag >= mpad[..., :-2]) & (mag >= mpad[..., 2:])
    del mpad, mz
    src, seg = fill_sources(mag, peak, sig, fs, angles[:, :T].to(dt))
    return src, ct, seg


def rt_pghi_phases_reference(mag, angles, gamma: float, n_fft: int, hop: int, tolerance: float,
                             chunk_frames: int, prev_mag=None, prev_phase=None) -> torch.Tensor:
    """Plain version of the RT-PGHI recurrence: magnitudes ``(B, T, F)``, ``T``
    a multiple of ``chunk_frames``, and the silent bins' angles ``(B, >= T,
    F)`` -> phases ``(B, T, F)``, in the kernel's order of operations (see
    the module notes): :func:`rt_fill_plan`, then the chain over frames.  The
    phase carry starts at ``prev_phase (B, F)`` (or zeros) and at each chunk
    boundary becomes ``atan2(m sin phi, m cos phi)`` of the last frame."""
    src, ct, seg = rt_fill_plan(mag, angles, gamma, n_fft, hop, tolerance, chunk_frames, prev_mag)
    B, T, n_bins = mag.shape
    T_c = int(chunk_frames)
    out = torch.empty((B, T, n_bins), device=mag.device, dtype=torch.float32)
    phi = (mag.new_zeros((B, n_bins)) if prev_phase is None else prev_phase.to(torch.float32).clone())
    for t in range(T):
        if t and t % T_c == 0:
            m = mag[:, t - 1]
            phi = torch.atan2(m * torch.sin(phi), m * torch.cos(phi))
        s = src[:, t]
        sc = s.clamp_min(0)
        v = (phi.gather(1, sc) + ct[:, t].gather(1, sc)) + seg[:, t]
        phi = torch.where(s >= 0, v, seg[:, t])
        out[:, t] = phi
    return out


# ---------------------------------------------------------------- launches
def _launch_encode(x2d, ops, n_fft, hop, T, magnitude: bool = False) -> torch.Tensor:
    """R: ``(B, T, F, 2)`` interleaved ``(re, im)``; ``magnitude``: ``|X|``
    ``(B, T, F)``.  ``ops``: :func:`_encode_operands`, whose route
    :func:`session_route` picks for the encode."""
    _require("encode", n_fft, hop)
    rows, teams = _encode_plan(n_fft, hop)
    B, F = x2d.shape[0], n_fft // 2 + 1
    a, b = ops
    if teams:
        if tuple(a.shape) != (n_fft,) or tuple(b.shape) != (2, n_fft):
            raise ValueError("the encode's FFT and smooth routes take the window (n_fft,) and the twiddle table "
                             "(2, n_fft)")
        ptrs, kn = (None, None, a.data_ptr(), b.data_ptr()), 0
    else:
        ptrs, kn = (a.data_ptr(), b.data_ptr(), None, None), a.shape[0]
    shape = (B, T, F) if magnitude else (B, T, F, 2)
    out = torch.empty(shape, dtype=torch.float32, device=x2d.device)
    lib = _build.load_library()
    with torch.cuda.device(x2d.device):
        code = lib.att_session_encode(
            x2d.data_ptr(), *ptrs, out.data_ptr(), B, x2d.shape[1], T, F,
            hop, n_fft // hop, kn, rows, teams, int(magnitude), _stream(),
        )
    name = "session_magnitude" if magnitude else "session_encode"
    _build.check(code, name)
    launches[name] += 1
    routes[name + ":" + session_route(n_fft, "encode")] += 1
    return out


def _rt_smem_bytes(n_bins: int, stage: int) -> int:
    """Shared memory of the recurrence's block, as ``csrc/pghi.cu:
    rt_pghi_smem_bytes`` lays it out: rows of ``n_bins`` rounded up to 4 (the
    logarithms of a stage's frames and the two before it, the chain's two
    phase rows), 64 words of chunk maxima and anchor flags, and two buffers
    of ``stage`` frames (a float segment sum, a float ``ct`` and an int16
    source a bin) and the magnitudes of the frame before."""
    row = -(-n_bins // 4) * 4
    return 4 * ((stage + 4) * row + 64) + 2 * row * (stage * 10 + 4)


def _rt_plan(n_bins: int, T_c: int) -> Tuple[int, int, int]:
    """``(stage, producers, chain)`` of the recurrence's block: the frames a
    stage holds (at most 16, within a chunk, as few stages a chunk as fit
    shared memory beside the other stage buffer, and of even size: 16 frames
    at 513 bins, 8 at 1025, 3 at 2049, 1 at 4096), the producer warps (a
    frame a warp) and the chain warps (one per 256 bins, at most 4); at most
    24 warps in all.  A seeded one-chunk session takes the same plan (22
    frames: two stages of 11).  Every ``n_bins <= 4096`` has a plan at any
    ``T_c``."""
    if not 2 <= n_bins <= RT_MAX_BINS or T_c < 1:
        raise ValueError("the recurrence takes 2 to %d bins and chunks of a frame or more" % RT_MAX_BINS)
    chain = min(4, -(-n_bins // 256))
    fit = min(T_c, _RT_STAGE)
    while _rt_smem_bytes(n_bins, fit) > MAX_SMEM:
        fit -= 1
    n = -(-T_c // fit)                           # the fewest stages a chunk, of even size
    stage = -(-T_c // n)
    return stage, min(stage, _RT_WARPS - chain), chain


def _launch_rt_pghi(mag, angles, gamma, n_fft, hop, tolerance, T_c, prev_mag=None,
                    prev_phase=None) -> torch.Tensor:
    """The RT-PGHI recurrence: ``mag (B, T, F)``, ``T`` a multiple of ``T_c``,
    ``angles (B, >= T, F)`` -> phases ``(B, T, F)``; seeded by ``prev_mag (B,
    2, F)`` and ``prev_phase (B, F)`` when given (counted as
    ``rt_pghi_seeded``); the block as :func:`_rt_plan` gives it."""
    _require("recurrence", n_fft, hop)
    B, T, F = mag.shape
    if T % T_c:
        raise ValueError("%d frames are no whole number of %d-frame chunks" % (T, T_c))
    seeded = prev_mag is not None
    if seeded:
        prev_mag = _checked_f32(prev_mag, mag.device, (B, 2, F), "prev_mag")
        prev_phase = _checked_f32(prev_phase, mag.device, (B, F), "prev_phase")
    fmul, inv_fmul, carrier = _constants(gamma, n_fft, hop)
    out = torch.empty_like(mag)
    lib = _build.load_library()
    with torch.cuda.device(mag.device):
        code = lib.att_rt_pghi_phases(
            mag.data_ptr(), angles.data_ptr(), prev_mag.data_ptr() if seeded else None,
            prev_phase.data_ptr() if seeded else None, out.data_ptr(), B, T, angles.shape[1], F, T_c,
            float(tolerance), fmul, inv_fmul, carrier, *_rt_plan(F, T_c), _stream(),
        )
    name = "rt_pghi_seeded" if seeded else "rt_pghi_phases"
    _build.check(code, name)
    launches[name] += 1
    return out


def _checked_f32(a: torch.Tensor, dev, shape, what: str) -> torch.Tensor:
    if a is None or tuple(a.shape) != tuple(shape):
        raise ValueError("%s must be %s, got %s" % (what, tuple(shape), None if a is None else tuple(a.shape)))
    return a.to(device=dev, dtype=torch.float32).contiguous()


def _launch_roundtrip(x2d, angles, ops, n_fft, hop, T) -> torch.Tensor:
    """L (``angles=None``) and M: ``(B, T * hop)``.  ``ops``:
    :meth:`_Session.roundtrip_operands`, whose route :func:`session_route`
    picks for the roundtrip at ``(n_fft, hop)``."""
    _require("roundtrip", n_fft, hop)
    rows, teams = _roundtrip_plan(n_fft, hop)
    wc, ws, syn, win, wsyn, tw = ops
    B, F = x2d.shape[0], n_fft // 2 + 1
    out = torch.empty((B, T * hop), dtype=torch.float32, device=x2d.device)
    lib = _build.load_library()
    with torch.cuda.device(x2d.device):
        code = lib.att_session_roundtrip(
            x2d.data_ptr(), None if angles is None else angles.data_ptr(),
            *[None if o is None else o.data_ptr() for o in (wc, ws, syn, win, wsyn, tw)], out.data_ptr(),
            B, x2d.shape[1], T, T if angles is None else angles.shape[1], F, hop, n_fft // hop,
            0 if teams else wc.shape[0], 0 if teams else syn.shape[1], rows, teams, _stream(),
        )
    name = "session_roundtrip" if angles is None else "session_random_roundtrip"
    _build.check(code, name)
    launches[name] += 1
    routes[name + ":" + session_route(n_fft, "roundtrip", hop)] += 1
    return out


def _launch_decode(mag, angles, ops, n_fft, hop, rows=None, name=None) -> torch.Tensor:
    """P: ``mag (B, T, F)`` with ``angles (B, >= T, F)``; S (``angles=None``):
    ``mag`` is the spectrum as ``(B, T, F, 2)`` floats.  ``ops``:
    :func:`_decode_operands`, whose route :func:`session_route` picks (the
    radix-7 instance where ``n_fft`` has a factor 7; counted under
    ``<name>:smooth``).
    ``rows`` output chunks per block for narrow blocks (default: the plan's),
    ``name`` the counter."""
    _require("decode", n_fft, hop)
    rows, teams = _decode_plan(n_fft, hop, None if rows is None else int(rows))
    syn, wsyn, tw = ops
    if teams and (wsyn is None or tw is None):
        raise ValueError("the decode's FFT and smooth routes take the synthesis window and the twiddle table")
    if not teams and syn is None:
        raise ValueError("the decode's product route takes the synthesis basis")
    B, T, F = mag.shape[:3]
    out = torch.empty((B, T * hop), dtype=torch.float32, device=mag.device)
    lib = _build.load_library()
    with torch.cuda.device(mag.device):
        code = lib.att_session_decode(
            mag.data_ptr(), None if angles is None else angles.data_ptr(),
            *[None if o is None else o.data_ptr() for o in (syn, wsyn, tw)], out.data_ptr(), B, T,
            T if angles is None else angles.shape[1], F, hop, n_fft // hop, 0 if teams else syn.shape[1], rows,
            teams, _stream(),
        )
    name = name or ("session_complex_decode" if angles is None else "session_random_decode")
    _build.check(code, name)
    launches[name] += 1
    routes[name + ":" + session_route(n_fft, "decode")] += 1
    return out


def rt_pghi_phases(mag, angles, gamma: float, n_fft: int, hop: int, tolerance: float,
                   chunk_frames: int, prev_mag=None, prev_phase=None) -> torch.Tensor:
    """The RT-PGHI recurrence of a whole session, ``mag (B, T, F)`` (``T`` a
    multiple of ``chunk_frames``) and angles ``(B, >= T, F)`` -> phases ``(B,
    T, F)``, from a carried history ``prev_mag (B, 2, F)`` / ``prev_phase (B,
    F)`` (both or neither; none: a fresh session): the kernel on a CUDA
    tensor, :func:`rt_pghi_phases_reference` on a CPU one."""
    if mag.ndim != 3 or angles.shape[0] != mag.shape[0] or angles.shape[-1] != mag.shape[-1]:
        raise ValueError("expected mag (B, T, F) and angles (B, >= T, F), got %s and %s"
                         % (tuple(mag.shape), tuple(angles.shape)))
    if (prev_mag is None) != (prev_phase is None):
        raise ValueError("prev_mag and prev_phase seed the recurrence together")
    mag = mag.to(torch.float32).contiguous()
    angles = _angles_3d(angles, mag.shape[0], mag.shape[1], mag.shape[2], mag.device)
    if mag.is_cuda:
        return _launch_rt_pghi(mag, angles, gamma, n_fft, hop, tolerance, chunk_frames, prev_mag, prev_phase)
    return rt_pghi_phases_reference(mag, angles, gamma, n_fft, hop, tolerance, chunk_frames,
                                    prev_mag, prev_phase)


def gl_project_analysis_reference(y, phase, window, n_fft: int, hop: int, ctx: int, keep_lo: int,
                                  keep_hi: int) -> torch.Tensor:
    """Plain version of O's projection analysis: the grid's overlap-add signal
    ``y (B, >= Tp hop)`` and phases ``(B, Tp, F)`` (``Tp = Tx + overlap - 1``)
    -> the phases with rows ``ctx .. Tx - 1`` outside ``[keep_lo, keep_hi)``
    replaced by ``atan2`` of the analysis of the re-framed rows (frame ``f``
    is ``y[f hop, f hop + n_fft)``); every other row as it was, bit for bit.
    On the FFT and smooth routes (:func:`session_route`, ``"project"``)
    ``frames_rfft_reference`` with the pairs ``(2j, 2j + 1)`` counted from
    ``ctx`` (``smooth=True`` on the latter: the mixed-radix schedule, its
    radix-7 stage where ``n_fft`` has a factor 7), the schedule of
    ``gl_project_analysis_fft_kernel`` and of the polish's analysis; on the
    product route the products with the window-folded basis."""
    Tx = phase.shape[1] - (n_fft // hop - 1)
    fr = y.unfold(-1, n_fft, hop)[:, ctx:Tx]
    route = session_route(n_fft, "project")
    if route == "product":
        WC, WS = _ana_basis(window.to(y.device), n_fft)
        new = torch.atan2(torch.matmul(fr, WS), torch.matmul(fr, WC))
    else:
        w = window.to(device=y.device, dtype=torch.float32)
        re, im = frames_rfft_reference(fr, w, smooth=route == "smooth")
        new = torch.atan2(im, re)
    rows = torch.arange(ctx, Tx, device=y.device)
    upd = ((rows < keep_lo) | (rows >= keep_hi))[None, :, None]
    out = phase.clone()
    out[:, ctx:Tx] = torch.where(upd, new, phase[:, ctx:Tx])
    return out


def gl_project_reference(mag, phase, inv_window, window, n_fft: int, hop: int, ctx: int,
                         keep_lo: int, keep_hi: int) -> torch.Tensor:
    """Plain version of O's projection: the grid's magnitudes and phases ``(B,
    Tx + overlap - 1, F)`` (the last ``overlap - 1`` frames zero magnitude) ->
    the phases after one projection: the synthesis of every grid frame
    divided by ``overlap`` (:func:`_synthesis_reference`: on the FFT and
    smooth routes the decode's schedule, ``mag (cos, sin)``, the frames paired
    ``(r, r + overlap)`` from ``-(overlap - 1)`` on, the overlap-add in class
    order), cut at ``Tp hop`` samples, then
    :func:`gl_project_analysis_reference` of that signal on rows ``ctx .. Tx
    - 1`` outside ``[keep_lo, keep_hi)``; every other row as it was."""
    overlap = n_fft // hop
    y = _synthesis_reference(mag * torch.cos(phase), mag * torch.sin(phase), inv_window, float(overlap),
                             n_fft, hop, mag.shape[1])
    return gl_project_analysis_reference(y, phase, window, n_fft, hop, ctx, keep_lo, keep_hi)


def gl_polish_reference(mag, phase, inv_window, window, n_fft: int, hop: int, ctx: int,
                        keep_lo: int, keep_hi: int, iters: int) -> torch.Tensor:
    """Plain version of O's polish (``gl_polish_fft_kernel``): ``iters`` calls
    of :func:`gl_project_reference` on the grid (``mag`` and ``phase`` ``(B,
    Tp, F)``, the last ``overlap - 1`` frames zero magnitude), the kernel's
    schedule on the FFT and smooth routes: its synthesis is P's, its analysis
    ``gl_project_analysis_fft_kernel``'s.  So it is also the plain version of
    ``iters`` two-launch projections.  Returns the new phases."""
    ph = phase.clone()
    for _ in range(int(iters)):
        ph = gl_project_reference(mag, ph, inv_window, window, n_fft, hop, ctx, keep_lo, keep_hi)
    return ph


def _launch_polish(mag, phase, window, proj_syn, n_fft, hop, ctx, keep_lo, keep_hi, iters, plan) -> None:
    """O's polish, one launch of ``gl_polish_fft_kernel`` (``plan``:
    :func:`_polish_plan`'s), ``phase`` updated in place."""
    teams, resident = plan
    _, wsyn, tw = proj_syn
    if wsyn is None or tw is None:
        raise ValueError("the polish takes the synthesis window and the twiddle table (_decode_operands)")
    B, Tp, F = mag.shape
    ov = n_fft // hop
    win = window.to(device=mag.device, dtype=torch.float32).contiguous()
    lib = _build.load_library()
    with torch.cuda.device(mag.device):
        code = lib.att_gl_polish(
            mag.data_ptr(), phase.data_ptr(), win.data_ptr(), wsyn.data_ptr(), tw.data_ptr(), B, Tp,
            Tp - (ov - 1), ctx, keep_lo, keep_hi, F, hop, ov, iters, teams, int(resident), _stream(),
        )
    _build.check(code, "gl_polish")
    launches["gl_polish"] += 1
    routes["gl_polish:" + session_route(n_fft, "polish")] += 1


def _project_operands(window, WC, WS, n_fft: int, device):
    """What O's analysis reads besides the signal on the route ``n_fft``
    takes (:func:`session_route`, ``"project"``): the window-folded bases
    ``WC``, ``WS`` (``(Kn, F)`` each) on the product route, the analysis
    window and the twiddle table on the FFT and smooth routes
    (:func:`_encode_operands`'s, built from ``window``)."""
    if session_route(n_fft, "project") == "product":
        if WC is None or WS is None:
            raise ValueError("the projection's product analysis takes the window-folded bases WC, WS")
        return WC, WS
    (tw,) = _tables(fft_twiddles, device, n_fft)
    return window.to(device=device, dtype=torch.float32).contiguous(), tw


def _launch_project_analysis(y, phase, ops, n_fft, hop, Tx, ctx, keep_lo, keep_hi) -> None:
    """O's projection analysis, ``phase`` updated in place, on the route of
    :func:`session_route` (``"project"``): ``gl_project_analysis_fft_kernel``
    in :func:`_encode_plan`'s blocks on the FFT and smooth routes,
    ``gl_project_analysis_kernel`` on the product route.  ``ops``:
    :func:`_project_operands`."""
    if not _two_launch_covers(n_fft, hop, Tx - ctx):
        raise NotImplementedError(
            "the projection analysis does not cover n_fft=%d hop=%d with %d polished frames: it needs P's "
            "limits and, on the product route, at most 40 frames whose samples fit shared memory (ROADMAP "
            "Queue 2, K10-K17)" % (n_fft, hop, Tx - ctx))
    B, Tp, F = phase.shape
    route = session_route(n_fft, "project")
    a, b = ops
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        if route == "product":
            code = lib.att_gl_project_analysis(
                y.data_ptr(), a.data_ptr(), b.data_ptr(), phase.data_ptr(), B, y.shape[1], Tp, Tx, ctx,
                keep_lo, keep_hi, F, hop, a.shape[0], _stream(),
            )
        else:
            if tuple(a.shape) != (n_fft,) or tuple(b.shape) != (2, n_fft):
                raise ValueError("the analysis's FFT and smooth routes take the window (n_fft,) and the twiddle "
                                 "table (2, n_fft)")
            rows, teams = _encode_plan(n_fft, hop)
            code = lib.att_gl_project_analysis_fft(
                y.data_ptr(), a.data_ptr(), b.data_ptr(), phase.data_ptr(), B, y.shape[1], Tp, Tx, ctx,
                keep_lo, keep_hi, F, hop, n_fft // hop, rows, teams, _stream(),
            )
    _build.check(code, "gl_project_analysis")
    launches["gl_project_analysis"] += 1
    routes["gl_project_analysis:" + route] += 1


#: output chunks per block of the projection's synthesis: narrow, so that one
#: session's grid (about 22 chunks at the main shape) spreads over several SMs
PROJECT_SYN_ROWS = 8


def gl_project(mag, phase, proj_syn, inv_window, window, WC, WS, n_fft: int, hop: int, ctx: int,
               keep_lo: int, keep_hi: int) -> torch.Tensor:
    """One projection of O's grid (see :func:`gl_project_reference`): on a
    CUDA tensor P's synthesis with ``proj_syn`` (:func:`_decode_operands`
    with the gain ``overlap``) in narrow blocks, then the analysis kernel of
    its route (the window-folded bases ``WC``, ``WS`` on the product route;
    the FFT and smooth routes read ``window`` and leave them unread, None
    will do), which updates ``phase`` in place and returns it; on a CPU
    tensor the plain version."""
    if not mag.is_cuda:
        return gl_project_reference(mag, phase, inv_window, window, n_fft, hop, ctx, keep_lo, keep_hi)
    Tx = mag.shape[1] - (n_fft // hop - 1)
    y = _launch_decode(mag, phase, proj_syn, n_fft, hop, rows=PROJECT_SYN_ROWS, name="gl_project_synthesis")
    _launch_project_analysis(y, phase, _project_operands(window, WC, WS, n_fft, y.device), n_fft, hop, Tx, ctx,
                             keep_lo, keep_hi)
    return phase


def gl_polish(mag, phase, proj_syn, inv_window, window, WC, WS, n_fft: int, hop: int, ctx: int,
              keep_lo: int, keep_hi: int, iters: int) -> torch.Tensor:
    """``iters`` projections of O's grid, the polish of one chunk.  On a CPU
    tensor :func:`gl_polish_reference` (``iters`` plain projections, which
    the kernels' routes compute alike).  On a CUDA tensor, where
    :func:`_polish_plan` takes the grid, one launch of
    ``gl_polish_fft_kernel`` (``proj_syn``: :func:`_decode_operands` with the
    gain ``overlap``), which updates ``phase`` in place and returns it;
    elsewhere ``iters`` calls of :func:`gl_project`, two launches each (the
    analysis bases ``WC``, ``WS`` are read on the product route only)."""
    iters = int(iters)
    if not mag.is_cuda:
        return gl_polish_reference(mag, phase, inv_window, window, n_fft, hop, ctx, keep_lo, keep_hi, iters)
    plan = _polish_plan(n_fft, hop, mag.shape[1])
    if plan is None:
        for _ in range(iters):
            phase = gl_project(mag, phase, proj_syn, inv_window, window, WC, WS, n_fft, hop, ctx, keep_lo,
                               keep_hi)
    elif iters > 0:
        _launch_polish(mag, phase, window, proj_syn, n_fft, hop, ctx, keep_lo, keep_hi, iters, plan)
    return phase


# ---------------------------------------------------------------- sessions
class _Session:
    """What the four sessions share: the chain's shape and its bases."""

    def __init__(self, chain, chunk_frames: int):
        parts = _parts(chain)
        if parts is None:
            raise ValueError("expected an [OverlapAdd, RealtimeSTFT-family] chain")
        self.chain = chain
        self.oadd, self.rt = parts
        self.n_fft, self.hop = self.rt.n_fft, self.rt.hop_length
        self.T_c = int(chunk_frames)
        self.F = self.n_fft // 2 + 1
        self.gain = float(self.oadd.gain_compensation)

    def analysis(self):
        return _ana_basis(self.rt.window, self.n_fft, _k_analysis(self.n_fft))

    def encode_operands(self):
        return _encode_operands(self.rt.window, self.n_fft)

    def synthesis(self):
        return _syn_basis(self.rt.inv_window, self.gain, self.n_fft, self.hop)

    def decode_operands(self):
        """What P and S read besides the spectra (:func:`_decode_operands`)."""
        return _decode_operands(self.rt.inv_window, self.gain, self.n_fft, self.hop)

    def roundtrip_operands(self):
        """What L and M read besides the signal, ``(wc, ws, syn, window, wsyn,
        twiddles)``: on the FFT and smooth routes the analysis window, the
        synthesis window over the gain and ``n_fft``
        (``frames_fft.irfft_window``) and the twiddle table; on the product
        route the window-folded bases."""
        route = session_route(self.n_fft, "roundtrip", self.hop)
        if route != "product":
            (tw,) = _tables(fft_twiddles, self.rt.window.device, self.n_fft)
            wsyn = irfft_window(self.rt.inv_window.to(torch.float32) / self.gain, self.n_fft, route == "smooth")
            return (None, None, None, self.rt.window.to(torch.float32).contiguous(), wsyn.contiguous(), tw)
        return self.analysis() + (self.synthesis(), None, None, None)

    def magnitude(self, xb: torch.Tensor, ops, T: int) -> torch.Tensor:
        """``|X|`` ``(B, T, F)`` of the session's frames (``ops``:
        :meth:`encode_operands`)."""
        if xb.is_cuda:
            return _launch_encode(xb, ops, self.n_fft, self.hop, T, magnitude=True)
        return session_magnitude_reference(xb, self.rt.window, self.n_fft, self.hop, T)

    def pghi_decode(self, mag: torch.Tensor, angles: torch.Tensor, syn, T: int) -> torch.Tensor:
        """RT-PGHI phases of ``mag (B, n_chunks T_c, F)`` and the synthesis of
        its first ``T`` frames, ``(B, T * hop)``."""
        ph = rt_pghi_phases(mag, angles, self.rt.gamma, self.n_fft, self.hop,
                            float(self.rt.tolerance), self.T_c)
        if mag.is_cuda:
            return _launch_decode(mag, ph, syn, self.n_fft, self.hop)[:, : T * self.hop]
        return session_decode_reference(mag[:, :T], ph, self.rt.inv_window, self.gain, self.n_fft,
                                        self.hop)

    def require(self, *kinds: str) -> None:
        """Raise unless every kernel a session launches covers the shape,
        before the first one runs."""
        for kind in kinds:
            _require(kind, self.n_fft, self.hop, self.T_c + int(self.rt.lookahead_frames),
                     int(self.rt.gl_context))

    def pghi_gl_decode(self, mag: torch.Tensor, angles: torch.Tensor, syn, T: int) -> torch.Tensor:
        """O after the analysis: magnitudes ``(B, n_chunks T_c, F)`` and the
        seed's angles ``(B, n_chunks (T_c + la), F)`` -> the synthesis of the
        first ``T`` committed frames, ``(B, T * hop)``.  The recurrence and
        the projection are the kernels on a CUDA tensor and their plain
        versions on a CPU one."""
        rt, n_fft, hop = self.rt, self.n_fft, self.hop
        iters = int(rt.gl_iterations)
        Tp = int(rt.gl_context) + self.T_c + int(rt.lookahead_frames) + n_fft // hop - 1
        proj_syn = WC = WS = None
        if mag.is_cuda:
            proj_syn = _decode_operands(rt.inv_window, float(n_fft // hop), n_fft, hop)
            if _polish_plan(n_fft, hop, Tp) is None and session_route(n_fft, "project") == "product":
                WC, WS = self.analysis()
        cm, cp = _pghi_gl_commits(
            mag, angles, rt, self.T_c,
            lambda mx, ph, ctx, lo, hi: gl_polish(mx, ph, proj_syn, rt.inv_window, rt.window, WC, WS,
                                                  n_fft, hop, ctx, lo, hi, iters))
        if mag.is_cuda:
            return _launch_decode(cm, cp, syn, n_fft, hop)[:, : T * hop]
        return session_decode_reference(cm[:, :T], cp, rt.inv_window, self.gain, n_fft, hop)


def _pghi_gl_commits(mag, angles, rt, T_c: int, polish):
    """O's host loop over the chunks, each over the whole batch: the seeded
    recurrence (:func:`rt_pghi_phases`), one call of ``polish(grid_mag,
    grid_phase, ctx, keep_lo, keep_hi)`` (the ``gl_iterations`` projections
    of the chunk, which return the new grid phases), the commit and the
    carries (module notes).  Returns the committed magnitudes and phases ``(B,
    n_chunks T_c, F)``."""
    n_fft, hop = rt.n_fft, rt.hop_length
    B, F = mag.shape[0], mag.shape[-1]
    ctx, la = int(rt.gl_context), int(rt.lookahead_frames)
    Tt = T_c + la
    keep_lo, keep_hi = rt.gl_frozen(T_c)
    args = (rt.gamma, n_fft, hop, float(rt.tolerance), Tt)
    mag_buf, ph_buf = mag.new_zeros((B, 2, F)), mag.new_zeros((B, F))
    gl_mag, gl_ph = mag.new_zeros((B, ctx, F)), mag.new_zeros((B, ctx, F))
    la_mag, tail = mag.new_zeros((B, la, F)), mag.new_zeros((B, n_fft // hop - 1, F))
    c_mag, c_ph = [], []
    for c in range(mag.shape[1] // T_c):
        m = torch.cat([la_mag, mag[:, c * T_c: (c + 1) * T_c]], dim=1)
        a = angles[:, c * Tt: (c + 1) * Tt].contiguous()
        ph0 = rt_pghi_phases(m.contiguous(), a, *args, prev_mag=mag_buf, prev_phase=ph_buf)
        mag_x = torch.cat([gl_mag, m, tail], dim=1).contiguous()
        ph = polish(mag_x, torch.cat([gl_ph, ph0, tail], dim=1).contiguous(), ctx, keep_lo, keep_hi)
        cm, cp = m[:, :T_c], ph[:, ctx: ctx + T_c]
        c_mag.append(cm)
        c_ph.append(cp)
        last = cm[:, -1]
        mag_buf = cm[:, -2:]
        ph_buf = torch.atan2(last * torch.sin(cp[:, -1]), last * torch.cos(cp[:, -1]))
        gl_mag = torch.cat([gl_mag, cm], dim=1)[:, -ctx:]
        gl_ph = torch.cat([gl_ph, cp], dim=1)[:, -ctx:]
        la_mag = m[:, T_c:]
    return torch.cat(c_mag, dim=1).contiguous(), torch.cat(c_ph, dim=1).contiguous()


def session_pghi_gl_reference(mag, angles, rt, gain: float, T_c: int, T: int) -> torch.Tensor:
    """Plain version of session O on any device: magnitudes ``(B, n_chunks
    T_c, F)`` and the seed's angles ``(B, n_chunks (T_c + la), F)`` -> ``(B, T
    * hop)``.  It is the generic scan's step, ``rt.pghi_gl_stream``, chunk by
    chunk from a fresh state (``torch.fft``, ``pghi_scan``), then the
    overlap-add of its frames divided by OverlapAdd's gain: the same function
    as the kernel route, written independently of its host loop."""
    B, hop = mag.shape[0], rt.hop_length
    Tt = T_c + int(rt.lookahead_frames)
    state = {k: v.to(mag.device) for k, v in rt.init_state((B,), mode="pghi_gl").items()}
    frames = []
    for c in range(mag.shape[1] // T_c):
        state, fr = rt.pghi_gl_stream(state, mag[:, c * T_c: (c + 1) * T_c],
                                      angles=angles[:, c * Tt: (c + 1) * Tt])
        frames.append(fr)
    return overlap_add(torch.cat(frames, dim=1)[:, :T], hop)[:, : T * hop] / gain


def make_fused_forward_session(chain, chunk_size: int):
    """Whole-session ENCODE ``fn(x (..., L)) -> (frames complex (..., T, F),
    final_state)`` for an ``[OverlapAdd, RealtimeSTFT-family]`` chain, ``T =
    n_chunks * chunk_size / hop``; equal to the generic ``scan_forward(chain,
    x, chunk_size)`` up to float32 rounding.  The forward moves no state
    past the framing ring, so the final state is the fresh one with the ring
    holding the chunk-padded signal's last ``(overlap - 1) hop`` samples."""
    s = _Session(chain, chunk_size // chain.transforms[1].hop_length)
    n_fft, hop = s.n_fft, s.hop
    ops = s.encode_operands()

    def run(x: torch.Tensor):
        batch_shape = tuple(x.shape[:-1])
        L = x.shape[-1]
        n_chunks = -(-L // chunk_size)
        T = n_chunks * s.T_c
        xb = _flat(x)
        if xb.is_cuda:
            spec = torch.view_as_complex(_launch_encode(xb, ops, n_fft, hop, T))
        else:
            re, im = session_encode_reference(xb, s.rt.window, n_fft, hop, T)
            spec = torch.complex(re, im)
        spec = spec.reshape(batch_shape + (T, s.F))
        state = chain.init_state(batch_shape)
        carry = n_fft - hop
        # the last `carry` samples of [initial ring, x, chunk padding]
        ring = torch.cat([state[0]["input_buffer"], x[..., -carry:].to(torch.float32)], dim=-1)
        ring = torch.nn.functional.pad(ring, (0, n_chunks * chunk_size - L))
        state[0] = dict(state[0], input_buffer=ring[..., -carry:].contiguous())
        return spec, state

    return run


def make_fused_roundtrip(chain, chunk_size: int):
    """Whole-session complex roundtrip ``fn(x (..., L)) -> (..., n_chunks *
    chunk_size)``; equal to the generic ``scan_roundtrip(chain, x,
    chunk_size)`` up to float32 rounding (output delayed by ``(overlap - 1)
    hop`` samples, like every streaming roundtrip)."""
    s = _Session(chain, chunk_size // chain.transforms[1].hop_length)
    ops = s.roundtrip_operands()

    def run(x: torch.Tensor) -> torch.Tensor:
        T = -(-x.shape[-1] // chunk_size) * s.T_c
        xb = _flat(x)
        if xb.is_cuda:
            y = _launch_roundtrip(xb, None, ops, s.n_fft, s.hop, T)
        else:
            y = session_roundtrip_reference(xb, s.rt.window, s.rt.inv_window, s.gain, s.n_fft,
                                            s.hop, T)
        return y.reshape(tuple(x.shape[:-1]) + (T * s.hop,))

    return run


def make_fused_random_roundtrip(chain, chunk_size: int, generator: Optional[torch.Generator] = None,
                                angles: Optional[torch.Tensor] = None):
    """Whole-session ``inversion_mode="random"`` roundtrip ``fn(x) -> audio``
    (the reference's default realtime mode): the analysis magnitudes with the
    session's angles (:func:`session_angles` from ``generator``, or
    ``angles`` ``(..., >= T, F)``), then the synthesis.  Equal to
    ``scan_roundtrip(chain, x, chunk_size, inversion_mode="random",
    generator=g)`` with a generator in the same state."""
    s = _Session(chain, chunk_size // chain.transforms[1].hop_length)
    ops = s.roundtrip_operands()

    def run(x: torch.Tensor) -> torch.Tensor:
        batch_shape = tuple(x.shape[:-1])
        n_chunks = -(-x.shape[-1] // chunk_size)
        T = n_chunks * s.T_c
        xb = _flat(x)
        a = (session_angles(batch_shape, n_chunks, s.T_c, s.F, xb.device, generator)
             if angles is None else _angles_3d(angles, xb.shape[0], T, s.F, xb.device))
        if xb.is_cuda:
            y = _launch_roundtrip(xb, a, ops, s.n_fft, s.hop, T)
        else:
            y = session_roundtrip_reference(xb, s.rt.window, s.rt.inv_window, s.gain, s.n_fft,
                                            s.hop, T, angles=a)
        return y.reshape(batch_shape + (T * s.hop,))

    return run


def make_fused_random_invert(chain, chunk_frames: int, generator: Optional[torch.Generator] = None,
                             angles: Optional[torch.Tensor] = None):
    """Whole-session ``inversion_mode="random"`` DECODE ``fn(mags (..., T,
    F)) -> audio (..., T * hop)``; equal to ``scan_invert(chain, mags,
    chunk_frames, inversion_mode="random", generator=g)`` with a generator in
    the same state (the draws cover ``ceil(T / chunk_frames)`` whole chunks,
    as the scan's zero-padded last chunk does)."""
    s = _Session(chain, chunk_frames)

    syn = s.decode_operands()

    def run(y: torch.Tensor) -> torch.Tensor:
        batch_shape = tuple(y.shape[:-2])
        T = y.shape[-2]
        n_chunks = -(-T // s.T_c)
        mag = y.reshape((-1, T, s.F)).to(torch.float32).contiguous()
        a = (session_angles(batch_shape, n_chunks, s.T_c, s.F, mag.device, generator)
             if angles is None else _angles_3d(angles, mag.shape[0], T, s.F, mag.device))
        if mag.is_cuda:
            out = _launch_decode(mag, a, syn, s.n_fft, s.hop)
        else:
            out = session_decode_reference(mag, a, s.rt.inv_window, s.gain, s.n_fft, s.hop)
        return out.reshape(batch_shape + (T * s.hop,))

    return run


def make_fused_magnitude_session(chain, chunk_size: int):
    """Whole-session MAGNITUDE encode ``fn(x (..., L)) -> |X| (..., T, F)``:
    R's analysis with an ``|X|`` epilogue; equal to ``scan_forward(chain, x,
    chunk_size)[0].abs()`` up to float32 rounding."""
    s = _Session(chain, chunk_size // chain.transforms[1].hop_length)
    ops = s.encode_operands()

    def run(x: torch.Tensor) -> torch.Tensor:
        T = -(-x.shape[-1] // chunk_size) * s.T_c
        xb = _flat(x)
        return s.magnitude(xb, ops, T).reshape(tuple(x.shape[:-1]) + (T, s.F))

    return run


def make_fused_pghi_roundtrip(chain, chunk_size: int, generator: Optional[torch.Generator] = None,
                              angles: Optional[torch.Tensor] = None):
    """Whole-session ``inversion_mode="pghi"`` roundtrip ``fn(x (..., L)) ->
    audio (..., n_chunks * chunk_size)``: the magnitude encode, the RT-PGHI
    recurrence with the chain's ``gamma`` and ``tolerance`` (silent bins take
    :func:`session_angles` from ``generator``, or ``angles (..., >= T,
    F)``), the synthesis.  Equal to ``scan_roundtrip(chain, x, chunk_size,
    inversion_mode="pghi", generator=g)`` with a generator in the same state,
    up to float32 rounding and the anchor decisions that rounding can flip at
    a threshold (then by quality)."""
    s = _Session(chain, chunk_size // chain.transforms[1].hop_length)
    ops = s.encode_operands()
    syn = s.decode_operands()

    def run(x: torch.Tensor) -> torch.Tensor:
        batch_shape = tuple(x.shape[:-1])
        n_chunks = -(-x.shape[-1] // chunk_size)
        T = n_chunks * s.T_c
        xb = _flat(x)
        if xb.is_cuda:
            s.require("encode", "recurrence", "decode")
        a = (session_angles(batch_shape, n_chunks, s.T_c, s.F, xb.device, generator)
             if angles is None else _angles_3d(angles, xb.shape[0], T, s.F, xb.device))
        y = s.pghi_decode(s.magnitude(xb, ops, T), a, syn, T)
        return y.reshape(batch_shape + (T * s.hop,))

    return run


def make_fused_pghi_invert(chain, chunk_frames: int, generator: Optional[torch.Generator] = None,
                           angles: Optional[torch.Tensor] = None):
    """Whole-session ``inversion_mode="pghi"`` DECODE ``fn(mags (..., T, F))
    -> audio (..., T * hop)``: the recurrence over ``ceil(T / chunk_frames)``
    whole chunks (the last zero-frame padded, as the generic scan pads it),
    then the synthesis.  Equal to ``scan_invert(chain, mags, chunk_frames,
    inversion_mode="pghi", generator=g)`` under the roundtrip's terms."""
    s = _Session(chain, chunk_frames)
    syn = s.decode_operands()

    def run(y: torch.Tensor) -> torch.Tensor:
        batch_shape = tuple(y.shape[:-2])
        T = y.shape[-2]
        n_chunks = -(-T // s.T_c)
        mag = y.reshape((-1, T, s.F)).to(torch.float32)
        mag = torch.nn.functional.pad(mag, (0, 0, 0, n_chunks * s.T_c - T)).contiguous()
        if mag.is_cuda:
            s.require("recurrence", "decode")
        a = (session_angles(batch_shape, n_chunks, s.T_c, s.F, mag.device, generator)
             if angles is None else _angles_3d(angles, mag.shape[0], n_chunks * s.T_c, s.F, mag.device))
        return s.pghi_decode(mag, a, syn, T).reshape(batch_shape + (T * s.hop,))

    return run


def make_fused_complex_invert(chain, chunk_frames: int):
    """Whole-session complex DECODE ``fn(spec complex (..., T, F)) -> audio
    (..., T * hop)`` (the explicit-phase serving path); equal to
    ``scan_invert(chain, spec, chunk_frames)`` up to float32 rounding (the
    chunking changes nothing: a session's output is the overlap-add of all
    its frames)."""
    s = _Session(chain, chunk_frames)
    syn = s.decode_operands()

    def run(y: torch.Tensor) -> torch.Tensor:
        batch_shape = tuple(y.shape[:-2])
        T = y.shape[-2]
        spec = y.reshape((-1, T, s.F)).to(torch.complex64)
        if spec.is_cuda:
            out = _launch_decode(torch.view_as_real(spec.contiguous()), None, syn, s.n_fft, s.hop)
        else:
            out = session_complex_decode_reference(spec, s.rt.inv_window, s.gain, s.n_fft, s.hop)
        return out.reshape(batch_shape + (T * s.hop,))

    return run


def _gl_angles(s: _Session, batch_shape, n_chunks: int, B: int, device, generator, angles):
    """The seed's draws, ``batch_shape + (T_c + la, F)`` a chunk (the frames
    the generic scan's ``pghi_stream`` draws for), or ``angles`` as given."""
    Tt = s.T_c + int(s.rt.lookahead_frames)
    if angles is None:
        return session_angles(batch_shape, n_chunks, Tt, s.F, device, generator)
    return _angles_3d(angles, B, n_chunks * Tt, s.F, device)


def make_fused_pghi_gl_roundtrip(chain, chunk_size: int, generator: Optional[torch.Generator] = None,
                                 angles: Optional[torch.Tensor] = None):
    """Whole-session ``inversion_mode="pghi_gl"`` roundtrip ``fn(x (..., L))
    -> audio (..., n_chunks * chunk_size)``: the magnitude encode, then O
    (per chunk the seeded recurrence and ``gl_iterations`` projections, then
    the synthesis of the committed frames; see the module notes).  The seed's
    silent bins take :func:`session_angles` of ``T_c + lookahead_frames``
    frames a chunk from ``generator``, or ``angles (..., >= n_chunks (T_c +
    la), F)``.  Equal to ``scan_roundtrip(chain, x, chunk_size,
    inversion_mode="pghi_gl", generator=g)`` with a generator in the same
    state, up to float32 rounding and the anchor decisions it can flip."""
    s = _Session(chain, chunk_size // chain.transforms[1].hop_length)
    ops = s.encode_operands()
    syn = s.decode_operands()

    def run(x: torch.Tensor) -> torch.Tensor:
        batch_shape = tuple(x.shape[:-1])
        n_chunks = -(-x.shape[-1] // chunk_size)
        T = n_chunks * s.T_c
        xb = _flat(x)
        if xb.is_cuda:
            s.require("encode", "recurrence", "decode", "project")
        a = _gl_angles(s, batch_shape, n_chunks, xb.shape[0], xb.device, generator, angles)
        y = s.pghi_gl_decode(s.magnitude(xb, ops, T), a, syn, T)
        return y.reshape(batch_shape + (T * s.hop,))

    return run


def make_fused_pghi_gl_invert(chain, chunk_frames: int, generator: Optional[torch.Generator] = None,
                              angles: Optional[torch.Tensor] = None):
    """Whole-session ``inversion_mode="pghi_gl"`` DECODE ``fn(mags (..., T,
    F)) -> audio (..., T * hop)``: O over ``ceil(T / chunk_frames)`` whole
    chunks (the last zero-frame padded, as the generic scan pads it).  Equal
    to ``scan_invert(chain, mags, chunk_frames, inversion_mode="pghi_gl",
    generator=g)`` under the roundtrip's terms."""
    s = _Session(chain, chunk_frames)
    syn = s.decode_operands()

    def run(y: torch.Tensor) -> torch.Tensor:
        batch_shape = tuple(y.shape[:-2])
        T = y.shape[-2]
        n_chunks = -(-T // s.T_c)
        mag = y.reshape((-1, T, s.F)).to(torch.float32)
        mag = torch.nn.functional.pad(mag, (0, 0, 0, n_chunks * s.T_c - T)).contiguous()
        if mag.is_cuda:
            s.require("recurrence", "decode", "project")
        a = _gl_angles(s, batch_shape, n_chunks, mag.shape[0], mag.device, generator, angles)
        return s.pghi_gl_decode(mag, a, syn, T).reshape(batch_shape + (T * s.hop,))

    return run
