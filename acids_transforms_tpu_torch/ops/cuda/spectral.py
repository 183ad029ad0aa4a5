"""Fused mel-spectrogram and two-channel representation forwards and their
fit statistics (twin of the JAX ``ops/pallas/spectral.py``, chunk-factored
and full-K paths).

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
DGT's gaussian for one) the full-K one, where frame ``t`` is the slice ``row[t
hop : t hop + n_fft]`` of the same padded rows.  The full-K front end of
``fused_melspec`` and ``fused_melspec_stats`` (kernels E and F) has three
routes, picked by ``n_fft`` alone (:func:`melspec_route`): where it is a
power of two from 64 to 4096
(``frames_fft.fft_covers``) the FFT route (``csrc/fft_smem.cuh:frames_rfft``,
the window and a twiddle table, no basis; plain version
``frames_fft.frames_rfft_reference``); where it is even and ``2^a 3^b 5^c
7^d`` from 64 to 4096 and no power of two (``frames_fft.fft_covers_smooth7``:
768, 640, 1536, 1920, and with a factor 7 896, 1344, 1568, ...) the smooth
route (the mixed-radix ``frames_rfft<true>``, its radix-7 instance
``frames_rfft<true, true>`` where ``n_fft`` has a factor 7; plain version
``frames_rfft_reference(..., smooth=True)``); elsewhere (1408 = 2^7 11, odd
sizes, above 4096) the product route (a basis of ``n_fft x 2F`` with the
window folded in, ``overlap`` times the multiply-adds of the factored form).
The forward and the statistics with ``taps`` (kernels A and B) take the same
FFT and smooth routes by the same rule, under the taps' own window
(``frames_fft.taps_window``): E's and F's instances compute A's and B's
functions for any window.  Every other ``n_fft`` keeps the factored front
end (:func:`_kernel_plan`).  All need ``hop | n_fft``.

``fused_spectral_repr`` and ``fused_repr_stats`` are the two-channel twins
(Polar, PolarIF, Cartesian): one DFT feeds channel 1 (``|X|`` through mel,
contrast and affine, or ``Re``) and channel 2 (the angle, the frame-local
instantaneous frequency, or ``Im``) with an affine each.  Their full-K front
end (kernels G and H full-K) takes the same three routes by the same rule
(:func:`melspec_route`; the radix-7 instance where ``n_fft`` has a factor 7)
wherever a block fits the smooth route: G with the IF and a mel bank at
4032/2016 keeps the product route, whose tile fits there
(:func:`_repr_route`).  On the FFT and the smooth route a block with the IF
computes two frames before its tile (the halo frame and its FFT partner), so
that every frame goes through the FFT with the partner it has in the plain
version's whole-clip schedule.  With ``taps`` the forward (kernel G) and the
statistics (kernel H) take G and H full-K's FFT or smooth route under the
taps' own window by that rule, the factored front end elsewhere
(:func:`_repr_plan`); their plain versions follow the same rule.
``routes`` counts the launches by route.

``melspec_forward_stage`` runs the factored forward cut after one of its
stages (``STAGES``) on prepared rows: the kernel of the floor sweep
(``tools/sweep_kernel_floor.py``), which attributes A's time to its stages.

``fused_melspec`` is also registered as the operator
``torch.ops.acids_transforms_tpu_torch.fused_melspec`` (:func:`fused_melspec_op`
calls it): its CUDA implementation launches the kernel, its CPU
implementation is the plain version and its fake implementation gives the
output's shape, so that ``torch.export`` keeps the kernel in a program as one
node (``export.py``).  ``op_calls`` counts the operator's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

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
from .frames_fft import (
    MAX_SMEM,
    SM_SMEM,
    TWO_BLOCKS_SMEM,
    fft_area_floats,
    fft_covers,
    fft_covers_smooth7,
    fft_max_teams,
    fft_smooth_max_teams,
    fft_twiddles,
    frames_rfft_reference,
    taps_window,
)

__all__ = [
    "fused_melspec",
    "fused_melspec_reference",
    "fused_melspec_stats",
    "fused_melspec_stats_reference",
    "fused_melspec_available",
    "melspec_route",
    "fused_melspec_op",
    "fused_spectral_repr",
    "fused_spectral_repr_reference",
    "fused_repr_stats",
    "fused_repr_stats_reference",
    "melspec_forward_stage",
    "melspec_forward_stage_reference",
    "STAGES",
    "launches",
    "routes",
    "op_calls",
    "reset_launches",
]

TILES = (32, 16, 8)               # frames per block the kernels can run, widest first
FFT_TILES = (32, 16, 8, 4, 2)     # the representation kernels' FFT route: also 4 and 2
_CONTRASTS = {"none": 0, None: 0, "log1p": 1}

#: kernel launches made by the wrappers of this module, by kernel
launches: Dict[str, int] = {
    "fused_melspec": 0, "fused_melspec_stats": 0,
    "fused_melspec_fullk": 0, "fused_melspec_stats_fullk": 0,
    "fused_spectral_repr": 0, "fused_spectral_repr_fullk": 0,
    "fused_repr_stats": 0, "fused_repr_stats_fullk": 0,
    "melspec_stage": 0,
}
#: the launches by route, ``"<kernel>:fft"`` / ``"<kernel>:smooth"`` /
#: ``"<kernel>:product"`` / ``"<kernel>:factored"`` (each also counts in
#: ``launches``): the full-K kernels, and A, B, G and H with taps (the FFT
#: route where ``fft_covers(n_fft)``, the smooth route where
#: :func:`melspec_route` says so and a block fits, its radix-7 instance
#: counted there too, the factored front end elsewhere)
routes: Dict[str, int] = {
    "fused_melspec_fullk:fft": 0, "fused_melspec_fullk:smooth": 0, "fused_melspec_fullk:product": 0,
    "fused_melspec_stats_fullk:fft": 0, "fused_melspec_stats_fullk:smooth": 0,
    "fused_melspec_stats_fullk:product": 0,
    "fused_melspec:fft": 0, "fused_melspec:smooth": 0, "fused_melspec:factored": 0,
    "fused_melspec_stats:fft": 0, "fused_melspec_stats:smooth": 0, "fused_melspec_stats:factored": 0,
    "fused_spectral_repr:fft": 0, "fused_spectral_repr:smooth": 0, "fused_spectral_repr:factored": 0,
    "fused_repr_stats:fft": 0, "fused_repr_stats:smooth": 0, "fused_repr_stats:factored": 0,
    "fused_spectral_repr_fullk:fft": 0, "fused_spectral_repr_fullk:smooth": 0,
    "fused_spectral_repr_fullk:product": 0,
    "fused_repr_stats_fullk:fft": 0, "fused_repr_stats_fullk:smooth": 0,
    "fused_repr_stats_fullk:product": 0,
}
#: channel-2 selectors of the representation kernels
SECONDS = {"phase": 0, "if": 1, "imag": 2}


#: launches of kernel A made through the registered operator (each also
#: counts in ``launches`` and ``routes``)
op_calls: Dict[str, int] = {"fused_melspec": 0}


def reset_launches() -> None:
    for d in (launches, routes, op_calls):
        for k in d:
            d[k] = 0


def _smem_bytes(tile_t: int, hop: int, overlap: int, n_bins: int) -> int:
    """Shared memory of one block on the factored and the product route, as
    ``csrc/spectral.cu`` lays it out."""
    work = 2 * 32 * 128 + 2 * 40 * 128 + 2 * 32 * 128 + 2 * 128
    return 4 * ((tile_t + overlap - 1) * hop + tile_t * n_bins + work)



def _fft_smem_bytes(tile_t: int, hop: int, overlap: int, n_bins: int, teams: int) -> int:
    """Shared memory of one block of E or F on the FFT or the smooth route:
    the same rows and magnitudes, then ``frames_rfft``'s window, twiddles and
    buffers on the route ``overlap * hop`` takes."""
    return 4 * ((tile_t + overlap - 1) * hop + tile_t * n_bins + fft_area_floats(overlap * hop, teams))


def _pick_tile(hop: int, overlap: int, n_bins: int) -> Optional[int]:
    """Frames per block: the widest tile whose hop chunks, magnitudes and work
    area fit shared memory (32 up to n_fft 1024, 16 at 2048, 8 at 4096), or
    None when none does."""
    for tile_t in TILES:
        if _smem_bytes(tile_t, hop, overlap, n_bins) <= MAX_SMEM:
            return tile_t
    return None


def _pick_fft_plan(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(tile_t, teams)`` of E and F on the FFT route: the widest frame tile
    whose block leaves room for a second one on the SM (``TWO_BLOCKS_SMEM``:
    the kernels run at most 128 registers a thread there, so shared memory
    decides), with as many FFTs side by side as 256 threads run (``4096 /
    n_fft``) or fewer; else the widest that fits shared memory at all; or
    None.  At 1024/256: 16 frames, 4 FFTs."""
    overlap, n_bins = n_fft // hop, n_fft // 2 + 1
    for limit in (TWO_BLOCKS_SMEM, MAX_SMEM):
        for tile_t in TILES:
            teams = fft_max_teams(n_fft)
            while teams >= 1:
                if _fft_smem_bytes(tile_t, hop, overlap, n_bins, teams) <= limit:
                    return tile_t, teams
                teams //= 2
    return None


def _pick_smooth_plan(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(tile_t, teams)`` of E and F (and A and B) on the smooth route, its
    radix-7 instance included: among the frame tiles (``TILES``) and the
    powers of two of FFTs side by side up to ``fft_smooth_max_teams(n_fft)``
    whose block fits shared memory, the most tile frames per round of pair
    FFTs times the blocks an SM holds (its shared memory at a block's bytes,
    1 KB reserved each, at most two: every instance of the route runs at
    most 128 registers, ``__launch_bounds__(256, 2)``), ties to the wider
    tile, then to fewer FFTs; or None (4032/2016: no tile fits).  768/256
    and 768/192: 16 frames of 4 FFTs; 640/160 32 of 4; 1536/384 8 of 2
    (each the fastest of a sweep of every plan on an H100,
    ``chip_smoke.py``'s ``smooth plan sweep``); 1920/480 16 of 2, 7 % over
    the fastest (8 of 1); 896/224 16 of 4."""
    overlap, n_bins = n_fft // hop, n_fft // 2 + 1
    best, score = None, 0.0
    for tile_t in TILES:
        teams = 1
        while teams <= fft_smooth_max_teams(n_fft):
            b = _fft_smem_bytes(tile_t, hop, overlap, n_bins, teams)
            if b <= MAX_SMEM:
                rounds = -(-(tile_t // 2) // teams)
                sc = min(2, SM_SMEM // (b + 1024)) * tile_t / rounds
                if sc > score:
                    best, score = (tile_t, teams), sc
            teams *= 2
    return best


def melspec_route(n_fft: int) -> str:
    """The route of E, F, G and H (and of A, B, G and H under the taps' own
    window) at ``n_fft``: ``"fft"`` where ``fft_covers`` (a power of two from
    64 to 4096), ``"smooth"`` where ``fft_covers_smooth7`` (even, ``2^a 3^b
    5^c 7^d``, 64 to 4096, no power of two: 768, 1920, ..., and on the
    radix-7 instances 896, 1344, 1568, ...), else ``"other"`` (the full-K
    product, the cosine-sum factored front end).  Where the smooth route's
    block does not fit, :func:`_kernel_plan` raises and :func:`_repr_route`
    keeps G's and H's product or factored front end."""
    if fft_covers(n_fft):
        return "fft"
    return "smooth" if fft_covers_smooth7(n_fft) else "other"


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


def _repr_smem_bytes(tile_t: int, hop: int, overlap: int, n_bins: int, stats: bool) -> int:
    """Shared memory of one block of the representation kernels (G, H): one
    hop chunk and one spectrum row more than A and B, and no channel-1 rows
    in the statistics kernel."""
    work = 2 * 32 * 128 + 2 * 40 * 128 + 2 * (tile_t + 1) * 128 + 2 * 128
    return 4 * ((tile_t + overlap) * hop + (0 if stats else tile_t * n_bins) + work)


def _repr_fft_halo(second: str) -> int:
    """Frames the FFT route computes before a block's tile: the IF's halo
    frame and its FFT partner."""
    return 2 if second == "if" else 0


def _repr_fft_smem_bytes(tile_t: int, hop: int, overlap: int, n_bins: int, teams: int, stats: bool,
                         second: str, mel: bool) -> int:
    """Shared memory of one block of G or H on the FFT or the smooth route,
    as ``csrc/spectral.cu:repr_fft_smem_floats`` lays it out: the hop chunks
    of the tile and its halo, rows of ``n_bins`` (channel 1 for the mel
    product, a multiple of 8; the IF's angles of the tile and its halo frame;
    the statistics kernel's two channels), then ``frames_rfft``'s area on the
    route ``overlap * hop`` takes."""
    if stats:
        c1, c2 = tile_t, tile_t + 1 if second == "if" else tile_t
    else:
        c1 = -(-tile_t // 8) * 8 if mel and second != "imag" else 0
        c2 = tile_t + 1 if second == "if" else 0
    rows = tile_t + _repr_fft_halo(second) + overlap - 1
    return 4 * (rows * hop + (c1 + c2) * n_bins + fft_area_floats(overlap * hop, teams))


def _pick_repr_fft_plan(n_fft: int, hop: int, stats: bool, second: str,
                        mel: bool) -> Optional[Tuple[int, int]]:
    """``(tile_t, teams)`` of G or H on the FFT route: among the frame tiles
    (``FFT_TILES``) and FFT counts (up to ``4096 / n_fft``) that fit shared
    memory, the one that gives an SM the most tile frames per round of pair
    FFTs (its blocks an SM, two where the block leaves room for a second, as
    ``_pick_fft_plan``, times ``tile_t`` over the rounds of its ``tile_t +
    halo`` frames), the wider tile on a tie; or None.  At 1024/256 with the
    IF and a mel bank: 8 frames, 4 FFTs."""
    overlap, n_bins = n_fft // hop, n_fft // 2 + 1
    best, score = None, 0.0
    for tile_t in FFT_TILES:
        pairs = -(-(tile_t + _repr_fft_halo(second)) // 2)
        teams = fft_max_teams(n_fft)
        while teams >= 1:
            smem = _repr_fft_smem_bytes(tile_t, hop, overlap, n_bins, teams, stats, second, mel)
            if smem <= MAX_SMEM:
                blocks = 2 if smem <= TWO_BLOCKS_SMEM else 1
                sc = blocks * tile_t / -(-pairs // teams)
                if sc > score:
                    best, score = (tile_t, teams), sc
            teams //= 2
    return best


def _pick_repr_smooth_plan(n_fft: int, hop: int, stats: bool, second: str,
                           mel: bool) -> Optional[Tuple[int, int]]:
    """``(tile_t, teams)`` of G or H on the smooth route, its radix-7
    instance included: among the frame tiles (``FFT_TILES``) and the powers
    of two of FFTs side by side up to ``fft_smooth_max_teams(n_fft)`` whose
    block fits shared memory, the most tile frames per round of pair FFTs
    (the ``tile_t + halo`` frames of a block with the IF) times the blocks
    an SM holds (its shared memory at a block's bytes, 1 KB reserved each,
    at most two: the instances' 128 registers), as :func:`_pick_smooth_plan`
    scores them; ties to the wider tile, then to fewer FFTs; or None (G with
    the IF and a mel bank at 4032/2016).  At 896/224: G and H with the IF 8
    frames of 4 FFTs, G Polar with a bank 16 of 4, H Polar 8 of 4."""
    overlap, n_bins = n_fft // hop, n_fft // 2 + 1
    best, score = None, 0.0
    for tile_t in FFT_TILES:
        pairs = -(-(tile_t + _repr_fft_halo(second)) // 2)
        teams = 1
        while teams <= fft_smooth_max_teams(n_fft):
            b = _repr_fft_smem_bytes(tile_t, hop, overlap, n_bins, teams, stats, second, mel)
            if b <= MAX_SMEM:
                sc = min(2, SM_SMEM // (b + 1024)) * tile_t / -(-pairs // teams)
                if sc > score:
                    best, score = (tile_t, teams), sc
            teams *= 2
    return best


def _pick_repr_tile(hop: int, overlap: int, n_bins: int) -> Optional[int]:
    """The widest frame tile whose forward block fits shared memory and whose
    rows (tile, halo frame and overlap) fit the analysis tile's 40, or None."""
    for tile_t in TILES:
        if tile_t + overlap <= 40 and _repr_smem_bytes(tile_t, hop, overlap, n_bins, False) <= MAX_SMEM:
            return tile_t
    return None


def _prepare_rows(x: torch.Tensor, n_fft: int, hop: int, center: bool, tile_t: int = TILES[0],
                  lead: int = 0):
    """Centre-pad, pad to the tiled row count plus halo, reshape to hop rows.

    One concatenate builds the padded signal (``lead`` zero chunks, reflect
    head, body, reflect tail, zero tail); a clip no longer than ``n_fft // 2``
    needs several reflections and takes the general pad.  Keeps int16 input
    int16.  Returns ``(rows (B, n_rows, hop), T, n_tiles)``."""
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
    n_rows = n_tiles * tile_t + overlap - 1 + lead
    total = n_rows * hop
    padded_len += lead * hop
    pieces = [x.new_zeros((B, lead * hop))] if lead else []
    if center and half >= L:
        pieces.append(_reflect_pad(x, half))
    else:
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


def _fullk_spectrum(x, n_fft, hop, center, window, smooth: bool = False):
    """(re, im) of the windowed STFT, the full-K kernels' front end: frames
    are overlapping slices of the prepared rows.  Where ``fft_covers(n_fft)``
    the FFT route's schedule over the whole clip (``frames_rfft_reference``:
    frames paired ``(2j, 2j + 1)``, as the kernels' even tiles pair them);
    with ``smooth`` where ``fft_covers_smooth7(n_fft)`` the smooth route's,
    radix-7 stages included where ``n_fft`` has a factor 7 (every kernel's
    plain version passes it where its route is smooth, through
    :func:`_spectrum`; without it tests get the product route there);
    otherwise the window lies in the basis."""
    rows, T, _ = _prepare_rows(x, n_fft, hop, center)
    flat = _rows_to_float(rows).reshape(rows.shape[0], -1)
    frames = flat.unfold(-1, n_fft, hop)[:, :T]
    if fft_covers(n_fft):
        return frames_rfft_reference(frames, window.to(x.device))
    if smooth and fft_covers_smooth7(n_fft):
        return frames_rfft_reference(frames, window.to(x.device), smooth=True)
    WC, WS = _fullk_basis(window.to(x.device), n_fft)
    return torch.matmul(frames, WC), torch.matmul(frames, WS)


def _spectrum(x, n_fft, hop, center, taps, window, route: Optional[str] = None):
    """(re, im) of the front end on ``route`` (default :func:`melspec_route`'s,
    the one E, F, A and B take): the full-K one on its route without
    ``taps``; with them, on the FFT or the smooth route, that route's
    schedule under the taps' own window, else the factored front end."""
    route = melspec_route(n_fft) if route is None else route
    if taps is None:
        return _fullk_spectrum(x, n_fft, hop, center, window, smooth=route == "smooth")
    if route != "other":
        (w,) = _tables(taps_window, x.device, tuple(float(t) for t in taps), n_fft)
        return _fullk_spectrum(x, n_fft, hop, center, w, smooth=route == "smooth")
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
    """Plain PyTorch version of :func:`fused_melspec` (same arguments), on the
    route the kernel takes (:func:`melspec_route`: the
    FFT or the smooth route's schedule over the whole clip, radix-7 stages
    included where ``n_fft`` has a factor 7, with ``taps`` under the taps'
    own window; the product or the factored front end elsewhere)."""
    _check_input(x, n_fft, hop_length, taps, window)
    re, im = _spectrum(x, n_fft, hop_length, center, taps, window)
    return _melspec_epilogue(re, im, mel_bank, offset, scale, contrast, power, out_dtype)


def _melspec_epilogue(re, im, mel_bank, offset, scale, contrast, power, out_dtype) -> torch.Tensor:
    """What the forward does after its front end, whichever front end gave
    ``(re, im)``: power or magnitude, mel product, contrast, affine, store."""
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
    """Plain PyTorch version of :func:`fused_melspec_stats`, on the route the
    kernel takes (as :func:`fused_melspec_reference`'s)."""
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


def _front_end(device, n_fft, hop, taps, window, *, fft: bool):
    """What the entry points take for the front end: the two basis tensors
    (None on the FFT and smooth routes), the twiddle pointers (None for
    full-K), the taps array, ``P`` (-1 selects a full-K front end) and the
    FFT route's window and twiddle table (None elsewhere).  ``fft``: the
    launch takes the FFT or the smooth route (one table: the smooth stages
    read its first ``fft_smooth_table(n_fft)`` entries), under ``window``, or
    with ``taps`` under the taps' own window (``taps_window``, float64
    rounded once)."""
    if fft:
        if taps is None:
            win = window.to(device=device, dtype=torch.float32).contiguous()
        else:
            (win,) = _tables(taps_window, device, tuple(float(t) for t in taps), n_fft)
        (tw,) = _tables(fft_twiddles, device, n_fft)
        return (None, None), None, None, (ctypes.c_float * 5)(), -1, (win, tw)
    if taps is None:
        WC, WS = _fullk_basis(window.to(device), n_fft)
        return (WC, WS), None, None, (ctypes.c_float * 5)(), -1, (None, None)
    Ch, Sh = _tables(_chunk_dft_matrices, device, n_fft, hop)
    twr, twi = _tables(_twiddles, device, n_fft, hop)
    taps_c, P = _build.taps_array(taps)
    return (Ch, Sh), twr.data_ptr(), twi.data_ptr(), taps_c, P, (None, None)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _kernel_plan(n_fft, hop, taps) -> Tuple[int, int]:
    """``(tile_t, teams)`` of the forward (A, E) and the statistics (B, F)
    for this shape, ``teams = 0`` off the FFT and smooth routes, or raise:
    the kernels never give way.  The route is :func:`melspec_route`'s, with
    taps (under their own window) or without:
    the FFT route (:func:`_pick_fft_plan`) where ``fft_covers(n_fft)``, the
    smooth route (:func:`_pick_smooth_plan`; the radix-7 instance where
    ``n_fft`` has a factor 7) where ``fft_covers_smooth7(n_fft)``, the
    factored or the product front end elsewhere.  Where the smooth route
    finds no plan (4032/2016) it raises: the product or factored block does
    not fit there either, and no shape changes route silently."""
    route = melspec_route(n_fft)
    if route != "other" and fused_melspec_available(n_fft, hop, taps):
        plan = _pick_fft_plan(n_fft, hop) if route == "fft" else _pick_smooth_plan(n_fft, hop)
        if plan is None:
            raise NotImplementedError(
                "the CUDA melspec kernels' %s route holds one block's tile in shared "
                "memory, which n_fft=%d hop=%d exceeds (ROADMAP Queue 2, K1); use "
                "backend='eager'" % ("FFT" if route == "fft" else "smooth", n_fft, hop)
            )
        return plan
    return _kernel_tile(n_fft, hop, taps), 0


def _kernel_tile(n_fft, hop, taps) -> int:
    """The frame tile of the factored and the product route for this shape,
    or raise: the kernels never give way."""
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
    tile_t, teams = _kernel_plan(n_fft, hop_length, taps)
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
    (bc, bs), twr_p, twi_p, taps_c, P, (win, tw) = _front_end(dev, n_fft, hop_length, taps, window,
                                                              fft=teams > 0)
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
            _ptr(bc), _ptr(bs), twr_p, twi_p,
            taps_c, P, int(power == 2.0), _CONTRASTS[contrast],
            bank_p, lo_p, hi_p, M, aff.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), _ptr(win), _ptr(tw), teams, _stream(),
        )
    name = "fused_melspec" if taps is not None else "fused_melspec_fullk"
    _build.check(code, name)
    _count(name, taps, teams, n_fft)
    return out


@torch.library.custom_op("acids_transforms_tpu_torch::fused_melspec", mutates_args=(), device_types="cuda")
def _fused_melspec_cuda(
    x: torch.Tensor, n_fft: int, hop_length: int, mel_bank: Optional[torch.Tensor], offset: torch.Tensor,
    scale: torch.Tensor, contrast: str, center: bool, taps: Optional[List[float]], power: float,
    out_dtype: torch.dtype, window: Optional[torch.Tensor],
) -> torch.Tensor:
    """The operator on a CUDA tensor: one launch of the kernel."""
    y = fused_melspec(x, n_fft, hop_length, mel_bank, offset, scale, contrast, center,
                      None if taps is None else tuple(taps), power, out_dtype, window)
    op_calls["fused_melspec"] += 1
    return y


@_fused_melspec_cuda.register_kernel("cpu")
def _fused_melspec_cpu(x, n_fft, hop_length, mel_bank, offset, scale, contrast, center, taps, power, out_dtype,
                       window):
    return fused_melspec_reference(x, n_fft, hop_length, mel_bank, offset, scale, contrast, center,
                                   None if taps is None else tuple(taps), power, out_dtype, window)


@_fused_melspec_cuda.register_fake
def _fused_melspec_fake(x, n_fft, hop_length, mel_bank, offset, scale, contrast, center, taps, power, out_dtype,
                        window):
    L = x.shape[-1]
    T = 1 + L // hop_length if center else (L - n_fft) // hop_length + 1
    M = n_fft // 2 + 1 if mel_bank is None else mel_bank.shape[1]
    return x.new_empty(tuple(x.shape[:-1]) + (T, M), dtype=out_dtype)


def fused_melspec_op(
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
    """:func:`fused_melspec` (same arguments) through the registered operator
    ``torch.ops.acids_transforms_tpu_torch.fused_melspec``: the kernel on a
    CUDA tensor, the plain version on a CPU tensor, and one node of the graph
    under ``torch.export``.  Float ``offset`` / ``scale`` become 0-d tensors
    on ``x``'s device, filled there (no host copy); a tensor is passed as it
    is (no host read)."""
    def as_t(v):
        return v if isinstance(v, torch.Tensor) else x.new_full((), float(v), dtype=torch.float32)

    return torch.ops.acids_transforms_tpu_torch.fused_melspec(
        x, n_fft, hop_length, mel_bank, as_t(offset), as_t(scale), contrast, center,
        None if taps is None else [float(t) for t in taps], power, out_dtype, window,
    )


def _count(name: str, taps, teams: int, n_fft: int) -> None:
    """One launch of ``name`` and its route: ``fft`` (``teams > 0`` at a
    power of two) or ``smooth`` (``teams > 0`` elsewhere), else ``product``
    without taps and ``factored`` with them."""
    launches[name] += 1
    if teams:
        route = "fft" if fft_covers(n_fft) else "smooth"
    else:
        route = "product" if taps is None else "factored"
    routes[name + ":" + route] += 1


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
    tile_t, teams = _kernel_plan(n_fft, hop_length, taps)
    if contrast not in _CONTRASTS:
        _apply_contrast(x, contrast)  # raises with the reason
    dev = x.device
    F = n_fft // 2 + 1
    rows, T, n_tiles = _prepare_rows(x, n_fft, hop_length, center, tile_t)
    B = rows.shape[0]
    (bc, bs), twr_p, twi_p, taps_c, P, (win, tw) = _front_end(dev, n_fft, hop_length, taps, window,
                                                              fft=teams > 0)
    partials = torch.empty((B * n_tiles, 4, F), dtype=torch.float32, device=dev)
    stats = torch.empty((4, F), dtype=torch.float64, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.att_melspec_stats(
            rows.data_ptr(), int(rows.dtype == torch.int16), B, n_tiles, tile_t,
            rows.shape[1], hop_length, n_fft // hop_length, F, T,
            _ptr(bc), _ptr(bs), twr_p, twi_p,
            taps_c, P, _CONTRASTS[contrast], partials.data_ptr(),
            stats.data_ptr(), _ptr(win), _ptr(tw), teams, _stream(),
        )
    name = "fused_melspec_stats" if taps is not None else "fused_melspec_stats_fullk"
    _build.check(code, name)
    _count(name, taps, teams, n_fft)
    return {
        "sum": stats[0].sum(),
        "sumsq": stats[1].sum(),
        "min": stats[2].min().float(),
        "max": stats[3].max().float(),
        "count": B * T * F,
    }


# ---------------------------------------------------------------------------
# Two-channel representations (kernels G and H)


def _check_repr(x, n_fft, hop, second, taps, window) -> None:
    if second not in SECONDS:
        raise ValueError("second must be 'phase', 'if' or 'imag', got %r" % (second,))
    _check_input(x, n_fft, hop, taps, window)


def _pin_nyquist(im: torch.Tensor) -> torch.Tensor:
    """The nyquist bin of a real signal's spectrum is real."""
    im = im.clone()
    im[..., -1] = 0.0
    return im


def _wrap_diff(d: torch.Tensor) -> torch.Tensor:
    """Principal value of a phase difference (the kernels' ``wrap_diff``)."""
    pi = math.pi
    m = torch.remainder(d + pi, 2.0 * pi) - pi
    m = torch.where((m == -pi) & (d > 0), pi, m)
    return torch.where(d.abs() < pi, d, m)


def _if_rows(ph: torch.Tensor, weighted: bool) -> torch.Tensor:
    """Frame-local IF of ``(B, T, F)`` phases: ``unwrap`` then the forward
    stencil, as ``IF(method="forward")`` computes it (the unwrapped
    consecutive difference is the principal difference)."""
    T = ph.shape[-2]
    v = torch.cat([ph[:, :1], _wrap_diff(ph[:, 1:] - ph[:, :-1]) * 0.5], dim=1)
    v = torch.cat([v[:, :-1] * (1.0 / math.pi), v[:, -1:]], dim=1)
    if weighted:
        # the parabolic window in float64, rounded once (as the kernels do)
        n = torch.arange(T, dtype=torch.float64, device=ph.device)
        w = (1.5 * T) / (T * T - 1.0) * (1.0 - ((n - (T / 2.0 - 1.0)) / (T / 2.0)) ** 2)
        v = v * w.to(torch.float32)[:, None]
    return v


def _repr_channels(x, n_fft, hop, center, taps, window, second, contrast, mel_bank, weighted,
                   stats: bool = False):
    """Pre-affine (channel 1, channel 2) of the representation kernels, on
    the front end and route the kernel takes (:func:`_repr_route`, for G or,
    with ``stats``, H): the FFT or the smooth route's schedule over the
    whole clip, radix-7 stages included where ``n_fft`` has a factor 7
    (with ``taps`` under the taps' own window), the factored or the product
    front end elsewhere."""
    mel = mel_bank is not None and second != "imag"
    route = _repr_route(n_fft, hop, taps, stats, second, mel)
    re, im = _spectrum(x, n_fft, hop, center, taps, window, route)
    im = _pin_nyquist(im)
    if second == "imag":
        return re, im
    mag = torch.sqrt(re * re + im * im)
    if mel_bank is not None:
        mag = torch.matmul(mag, mel_bank)
    # a zero imaginary part of either sign counts as +0 (a negative real
    # axis is +pi), and the nyquist angle is exactly 0 or pi
    ph = torch.atan2(torch.where(im == 0, 0.0, im), re)
    ph[..., -1] = torch.where(re[..., -1] < 0, math.pi, 0.0)
    ch2 = ph if second == "phase" else _if_rows(ph, weighted)
    return _apply_contrast(mag, contrast), ch2


def fused_spectral_repr_reference(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    second: str,
    mel_bank: Optional[torch.Tensor] = None,
    aff=(0.0, 1.0, 0.0, 1.0),
    contrast: str = "log1p",
    weighted: bool = False,
    center: bool = True,
    taps: Optional[tuple] = None,
    window: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_spectral_repr`, on the route the
    kernel takes (:func:`_repr_route`)."""
    _check_repr(x, n_fft, hop_length, second, taps, window)
    if second == "imag":
        mel_bank, contrast = None, "none"
    c1, c2 = _repr_channels(x, n_fft, hop_length, center, taps, window, second, contrast,
                            mel_bank, weighted)
    return (c1 - aff[0]) / aff[1], (c2 - aff[2]) / aff[3]


def fused_repr_stats_reference(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    second: str,
    contrast: str = "log1p",
    weighted: bool = False,
    center: bool = True,
    taps: Optional[tuple] = None,
    window: Optional[torch.Tensor] = None,
) -> dict:
    """Plain PyTorch version of :func:`fused_repr_stats`, on the route the
    kernel takes (:func:`_repr_route` for H: with ``taps`` the FFT or the
    smooth route's schedule under the taps' own window where
    :func:`melspec_route` says so, radix-7 stages included)."""
    x = x.reshape((-1, x.shape[-1]))
    _check_repr(x, n_fft, hop_length, second, taps, window)
    if second == "imag":
        contrast = "none"
    c1, c2 = _repr_channels(x, n_fft, hop_length, center, taps, window, second, contrast,
                            None, weighted, stats=True)

    def chan(v):
        vd = v.double()
        return {"sum": vd.sum(), "sumsq": (vd * vd).sum(), "min": v.min(), "max": v.max()}

    return {"ch1": chan(c1), "ch2": chan(c2), "count": int(c1.numel())}


def _repr_refusal(n_fft, hop) -> NotImplementedError:
    return NotImplementedError(
        "the CUDA representation kernels hold one block's tile in shared "
        "memory, which n_fft=%d hop=%d exceeds (ROADMAP Queue 2, K7: shapes "
        "above n_fft 4096); use backend='eager'" % (n_fft, hop)
    )


def _repr_kernel_tile(n_fft, hop, taps) -> int:
    """The representation kernels' frame tile on the factored and the
    product route for this shape, or raise."""
    if not fused_melspec_available(n_fft, hop, taps):
        _kernel_tile(n_fft, hop, taps)  # raises with the reason
    tile_t = _pick_repr_tile(hop, n_fft // hop, n_fft // 2 + 1)
    if tile_t is None:
        raise _repr_refusal(n_fft, hop)
    return tile_t


def _repr_route(n_fft, hop, taps, stats, second, mel) -> str:
    """The route of G (``stats=False``, ``mel``: with a mel bank) or H at
    this shape: :func:`melspec_route`'s, except where its smooth route finds
    no block that fits shared memory (:func:`_pick_repr_smooth_plan`) but
    the product or factored tile does (:func:`_pick_repr_tile`): there
    ``"other"``.  Of the 42 even 7-smooth shapes with a factor 7 the gate
    takes, that is only G with the IF and a mel bank at 4032/2016 (its
    narrowest smooth block needs 237,316 B), which so keeps the route it
    had.  The wrappers (:func:`_repr_plan`) and the plain versions
    (:func:`_repr_channels`) read it alike."""
    route = melspec_route(n_fft)
    if (route == "smooth" and fused_melspec_available(n_fft, hop, taps)
            and _pick_repr_smooth_plan(n_fft, hop, stats, second, mel) is None
            and _pick_repr_tile(hop, n_fft // hop, n_fft // 2 + 1) is not None):
        return "other"
    return route


def _repr_plan(n_fft, hop, taps, stats, second, mel) -> Tuple[int, int]:
    """``(tile_t, teams)`` of the representation kernels for this shape,
    ``teams = 0`` off the FFT and smooth routes, or raise: the kernels never
    give way.  The route is :func:`_repr_route`'s for every launch, with
    taps (under their own window) or without: the FFT route
    (:func:`_pick_repr_fft_plan`) where ``fft_covers(n_fft)``, the smooth
    route (:func:`_pick_repr_smooth_plan`; the radix-7 instance where
    ``n_fft`` has a factor 7) where ``fft_covers_smooth7(n_fft)`` and a block
    fits, the factored or the product front end elsewhere."""
    route = _repr_route(n_fft, hop, taps, stats, second, mel)
    if route != "other" and fused_melspec_available(n_fft, hop, taps):
        pick = _pick_repr_fft_plan if route == "fft" else _pick_repr_smooth_plan
        plan = pick(n_fft, hop, stats, second, mel)
        if plan is None:
            raise _repr_refusal(n_fft, hop)
        return plan
    return _repr_kernel_tile(n_fft, hop, taps), 0


def _launch_repr(x, n_fft, hop, second, taps, window, contrast, weighted, center, stats,
                 mel_bank=None, aff=None):
    """One launch of kernel G (``stats=False``) or H; returns its outputs."""
    tile_t, teams = _repr_plan(n_fft, hop, taps, stats, second, mel_bank is not None and not stats)
    if contrast not in _CONTRASTS:
        _apply_contrast(x, contrast)  # raises with the reason
    dev = x.device
    F = n_fft // 2 + 1
    # the FFT and smooth routes read frame f from row f + its halo, the others from row f + 1
    lead = _repr_fft_halo(second) if teams else 1
    rows, T, n_tiles = _prepare_rows(x, n_fft, hop, center, tile_t, lead=lead)
    B = rows.shape[0]
    (bc, bs), twr_p, twi_p, taps_c, P, (win, tw) = _front_end(dev, n_fft, hop, taps, window,
                                                              fft=teams > 0)
    bank_p = lo_p = hi_p = None
    if mel_bank is not None:
        if mel_bank.device != dev or mel_bank.dtype != torch.float32 or tuple(mel_bank.shape) != (F, F):
            raise ValueError("mel_bank must be a float32 (n_bins, n_bins) square bank on the input's device")
        bank = mel_bank.contiguous()
        lo, hi = _mel_band(bank)
        bank_p, lo_p, hi_p = bank.data_ptr(), lo.data_ptr(), hi.data_ptr()
    out1 = out2 = partials = stats_t = aff_t = None
    if stats:
        partials = torch.empty((B * n_tiles, 8, F), dtype=torch.float32, device=dev)
        stats_t = torch.empty((8, F), dtype=torch.float64, device=dev)
    else:
        aff_t = torch.stack([torch.as_tensor(a, dtype=torch.float32, device=dev).reshape(()) for a in aff])
        out1 = torch.empty((B, T, F), dtype=torch.float32, device=dev)
        out2 = torch.empty((B, T, F), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.att_repr(
            int(stats), rows.data_ptr(), int(rows.dtype == torch.int16), B, n_tiles, tile_t,
            rows.shape[1], hop, n_fft // hop, F, T, ptr(bc), ptr(bs), twr_p, twi_p,
            taps_c, P, SECONDS[second], int(bool(weighted)), _CONTRASTS[contrast],
            bank_p, lo_p, hi_p, ptr(aff_t), ptr(out1), ptr(out2), ptr(partials), ptr(stats_t),
            ptr(win), ptr(tw), teams, _stream(),
        )
    name = ("fused_repr_stats" if stats else "fused_spectral_repr") + ("" if taps is not None else "_fullk")
    _build.check(code, name)
    _count(name, taps, teams, n_fft)
    return (stats_t, B * T * F) if stats else (out1, out2)


def fused_spectral_repr(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    second: str,
    mel_bank: Optional[torch.Tensor] = None,
    aff=(0.0, 1.0, 0.0, 1.0),
    contrast: str = "log1p",
    weighted: bool = False,
    center: bool = True,
    taps: Optional[tuple] = None,
    window: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused two-channel spectral representation ``(B, L) -> (y1, y2)``.

    One pass computes both channels of a stacked representation from one
    windowed DFT; the complex spectrogram never reaches device memory:

    - ``second="phase"`` (Polar): y1 = normalized mel / contrast magnitude,
      y2 = normalized angle (``atan2``);
    - ``second="if"`` (PolarIF): y2 = normalized instantaneous frequency,
      the frame-local form of ``unwrap`` + the forward stencil (what
      ``IF(method="forward")`` computes); ``weighted`` applies the parabolic
      frame window;
    - ``second="imag"`` (Cartesian): y1 = normalized real part, y2 =
      normalized imaginary part (``mel_bank`` and ``contrast`` unused).

    The nyquist bin's imaginary part is taken as 0 (its angle is 0 or pi).
    ``aff = (off1, scale1, off2, scale2)``: the two normalizer affines,
    floats or 0-d tensors on ``x``'s device.  ``mel_bank`` is the square
    ``(n_bins, n_bins)`` bank or None.  ``taps`` / ``window`` select the
    front end as in :func:`fused_melspec`; ``x`` may be int16 PCM.  Returns
    float32 ``((B, T, n_bins), (B, T, n_bins))``; the nyquist drop and the
    stacking are the caller's."""
    if x.ndim == 1:
        y1, y2 = fused_spectral_repr(x[None], n_fft, hop_length, second, mel_bank, aff, contrast,
                                     weighted, center, taps, window)
        return y1[0], y2[0]
    if not x.is_cuda:
        return fused_spectral_repr_reference(x, n_fft, hop_length, second, mel_bank, aff, contrast,
                                             weighted, center, taps, window)
    _check_repr(x, n_fft, hop_length, second, taps, window)
    if second == "imag":
        mel_bank, contrast = None, "none"
    return _launch_repr(x, n_fft, hop_length, second, taps, window, contrast, weighted, center,
                        False, mel_bank, aff)


def fused_repr_stats(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    second: str,
    contrast: str = "log1p",
    weighted: bool = False,
    center: bool = True,
    taps: Optional[tuple] = None,
    window: Optional[torch.Tensor] = None,
) -> dict:
    """One-pass fit statistics of both channels of :func:`fused_spectral_repr`.

    Returns ``{"ch1": {...}, "ch2": {...}, "count"}``, each channel's dict
    holding ``sum`` / ``sumsq`` (float64) and ``min`` / ``max`` as 0-d tensors
    on ``x``'s device over the whole (batch, frames, bins) extraction, and
    ``count`` as an exact Python int.  Channel 1 is what the transforms fit
    on: the non-mel contrasted magnitude (``Magnitude.fit``) or the real
    part; channel 2 the wrapped phase, the frame-local IF or the imaginary
    part.  Deterministic: per-block partials reduced in a fixed order."""
    if x.ndim == 1:
        x = x[None]
    x = x.reshape((-1, x.shape[-1]))
    if not x.is_cuda:
        return fused_repr_stats_reference(x, n_fft, hop_length, second, contrast, weighted, center,
                                          taps, window)
    _check_repr(x, n_fft, hop_length, second, taps, window)
    if second == "imag":
        contrast = "none"
    s, count = _launch_repr(x, n_fft, hop_length, second, taps, window, contrast, weighted, center,
                            True)

    def chan(r0):
        return {"sum": s[r0].sum(), "sumsq": s[r0 + 1].sum(),
                "min": s[r0 + 2].min().float(), "max": s[r0 + 3].max().float()}

    return {"ch1": chan(0), "ch2": chan(4), "count": count}


# ---------------------------------------------------------------------------
# The floor sweep's stage prefixes of A (kernel T)

#: stages of the floor sweep in the order they build A up, numbered as the JAX
#: tool's (``tools/sweep_kernel_floor.py``); its ``s2_dots3`` (a bf16x3
#: product) has no counterpart, since A's chunk product is one fp32 pass.
#: ``s8_mel_dense`` is ``s6_mel_banded`` with the dense mel product.
STAGES = {"s0_copy": 0, "s1_dots": 1, "s3_combine": 3, "s4_taps": 4, "s5_mag": 5,
          "s6_mel_banded": 6, "s7_full": 7, "s8_mel_dense": 8}


def _stage_shape(rows, stage, n_fft, hop, n_frames, taps, mel_bank):
    """``(stage number, tile_t, n_tiles)`` after checking the arguments: rows
    as ``_prepare_rows`` lays them out for A's frame tile."""
    if stage not in STAGES:
        raise ValueError("stage must be one of %s, got %r" % (", ".join(STAGES), stage))
    if taps is None or not fused_melspec_available(n_fft, hop, taps):
        raise ValueError("the stages cut A's factored front end: cosine-sum taps needed")
    tile_t = _kernel_tile(n_fft, hop, taps)
    n_tiles = -(-n_frames // tile_t)
    if (rows.dtype != torch.float32 or rows.ndim != 3 or not rows.is_contiguous()
            or tuple(rows.shape[1:]) != (n_tiles * tile_t + n_fft // hop - 1, hop)):
        raise ValueError("rows must be contiguous float32 (B, %d, %d) as _prepare_rows makes them for "
                         "%d frames" % (n_tiles * tile_t + n_fft // hop - 1, hop, n_frames))
    F = n_fft // 2 + 1
    if mel_bank.dtype != torch.float32 or mel_bank.device != rows.device or mel_bank.shape[0] != F:
        raise ValueError("mel_bank must be float32 (n_bins, n_mels) on the rows' device")
    return STAGES[stage], tile_t, n_tiles


def melspec_forward_stage_reference(
    rows: torch.Tensor,
    stage: str,
    n_fft: int,
    hop_length: int,
    n_frames: int,
    taps: tuple,
    mel_bank: torch.Tensor,
    offset=0.0,
    scale=1.0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`melspec_forward_stage`."""
    s, tile_t, n_tiles = _stage_shape(rows, stage, n_fft, hop_length, n_frames, taps, mel_bank)
    B, F = rows.shape[0], n_fft // 2 + 1
    if s == 0:
        first = rows[:, 0: n_tiles * tile_t: tile_t, 0].repeat_interleave(tile_t, dim=1)
        return rows.new_zeros((B, n_frames, F)) + first[:, :n_frames, None]
    Ch, Sh = _tables(_chunk_dft_matrices, rows.device, n_fft, hop_length)
    Cre = torch.matmul(rows, Ch)
    Cim = torch.matmul(rows, Sh)
    if s == 1:
        return (Cre + Cim)[:, :n_frames]
    Xre, Xim = _twiddle_analysis(Cre, Cim, n_fft, hop_length, n_frames)
    re, im = _taps_conv(Xre, Xim, taps[:1] if s == 3 else taps)
    mag = re * re + im * im
    if s <= 4:
        return mag
    mag = torch.sqrt(mag)
    if s == 5:
        return mag
    mel = torch.matmul(mag, mel_bank)
    if s != 7:
        return mel
    return (torch.log1p(mel) - offset) / scale


def melspec_forward_stage(
    rows: torch.Tensor,
    stage: str,
    n_fft: int,
    hop_length: int,
    n_frames: int,
    taps: tuple,
    mel_bank: torch.Tensor,
    offset=0.0,
    scale=1.0,
) -> torch.Tensor:
    """A (the factored forward of :func:`fused_melspec`) cut after ``stage``.

    ``rows``: float32 rows from ``_prepare_rows(x, n_fft, hop_length, center,
    tile_t)`` with A's frame tile, ``n_frames`` the frames they hold.  A's
    configuration: cosine-sum ``taps``, magnitudes (power 1), ``mel_bank``,
    log1p, ``(y - offset) / scale``.  Each stage stores what its work ends in:
    ``s0_copy`` zeros plus its block's first sample, ``s1_dots`` ``Cre +
    Cim`` of the chunk product at each frame's first chunk, ``s3_combine``
    the power of the combined spectrum times the centre tap, ``s4_taps`` the
    power after the whole taps conv, ``s5_mag`` the magnitude (all ``(B,
    n_frames, n_bins)``), ``s6_mel_banded`` / ``s8_mel_dense`` its mel
    product and ``s7_full`` A's output (``(B, n_frames, n_mels)``).  On a
    CUDA tensor one launch of kernel T with A's grid, threads and shared
    memory, whatever the stage needs."""
    if not rows.is_cuda:
        return melspec_forward_stage_reference(rows, stage, n_fft, hop_length, n_frames, taps,
                                               mel_bank, offset, scale)
    s, tile_t, n_tiles = _stage_shape(rows, stage, n_fft, hop_length, n_frames, taps, mel_bank)
    dev = rows.device
    B, F = rows.shape[0], n_fft // 2 + 1
    (bc, bs), twr_p, twi_p, taps_c, P, _ = _front_end(dev, n_fft, hop_length, taps, None, fft=False)
    bank = mel_bank.contiguous()
    lo, hi = _mel_band(bank)
    M = bank.shape[1]
    aff = torch.stack(
        [torch.as_tensor(offset, dtype=torch.float32, device=dev).reshape(()),
         torch.as_tensor(scale, dtype=torch.float32, device=dev).reshape(())]
    )
    out = torch.empty((B, n_frames, M if s >= 6 else F), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.att_melspec_stage(
            s, rows.data_ptr(), B, n_tiles, tile_t, rows.shape[1], hop_length,
            n_fft // hop_length, F, n_frames, bc.data_ptr(), bs.data_ptr(), twr_p, twi_p,
            taps_c, P, bank.data_ptr(), lo.data_ptr(), hi.data_ptr(), M, aff.data_ptr(),
            out.data_ptr(), _stream(),
        )
    _build.check(code, "melspec_stage")
    launches["melspec_stage"] += 1
    return out
