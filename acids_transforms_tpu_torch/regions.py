"""Auto-dispatch region table of the port (twin of the JAX ``regions.py``).

``backend="auto"`` takes a hand-written kernel only inside the region where
it was measured faster than the route ``auto`` would otherwise run, and a
streaming session kernel only up to its measured batch cap and memory
footprint.  Every numeric gate loads from ``dispatch_regions.json`` beside
this module, measured on the H100 by ``tools/sweep_regions.py``; each value
carries a ``_why`` with the card, its power limit and the ratios measured.
None comes from the JAX package's table, whose values are TPU crossovers.

A shape region is ``n_fft_min <= n_fft <= n_fft_max``, and with
``fft_route_only`` the kernel's shared-memory FFT route only (``n_fft`` a
power of two, 64-4096): at any other n_fft the kernels take their product
or factored front end, which the sweep measured slower than the eager
route.  A region has no overlap bound: the kernels' own gate (2 <= n_fft /
hop <= 8) is the whole range, and the kernel won at each overlap measured,
so the functions take ``hop_length`` for the JAX package's signatures only.
A region that is None holds no shape.  The tests
(``tests/test_torch_regions.py``) hold the planners' live decisions against
stated expectations.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Optional

from .ops.cuda.frames_fft import fft_covers

__all__ = [
    "table",
    "melspec_region_ok",
    "repr_region_ok",
    "mfcc_region_ok",
    "fit_fullk_max_n_fft",
    "fit_fullk_region_ok",
    "angle_cap_bytes",
    "sinebank_cap_bytes",
    "batch_cap",
]


@lru_cache(maxsize=None)
def table() -> dict:
    path = os.path.join(os.path.dirname(__file__), "dispatch_regions.json")
    with open(path) as f:
        return json.load(f)


def _in_shape_region(r: Optional[dict], n_fft: int) -> bool:
    if r is None:
        return False
    if r["fft_route_only"] and not fft_covers(n_fft):
        return False
    return r["n_fft_min"] <= n_fft <= r["n_fft_max"]


def melspec_region_ok(n_fft: int, hop_length: int, has_taps: bool) -> bool:
    """The fused log-mel / magnitude forward: A with cosine-sum taps, E for
    any other window (the DGT's gaussian)."""
    t = table()["fuse_forward"]
    return _in_shape_region(t["melspec_taps" if has_taps else "melspec_fullk"], n_fft)


def repr_region_ok(n_fft: int, hop_length: int, has_taps: bool, second: str) -> bool:
    """The two-channel forward G: PolarIF (``second == "if"``) has its own
    region, Polar and Cartesian share one; each with taps and full-K."""
    r = table()["fuse_forward"]["repr_if" if second == "if" else "repr_phase_imag"]
    return _in_shape_region(r["taps" if has_taps else "fullk"], n_fft)


def mfcc_region_ok(n_fft: int, hop_length: int) -> bool:
    return _in_shape_region(table()["fuse_forward"]["mfcc"], n_fft)


def fit_fullk_max_n_fft() -> int:
    return int(table()["fuse_fit"]["fullk_n_fft_max"])


def fit_fullk_region_ok(n_fft: int) -> bool:
    """The one-pass fit of a window without taps (F, H full-K) up to its
    measured largest n_fft, on the FFT route only where the table says so."""
    t = table()["fuse_fit"]
    if t["fullk_fft_route_only"] and not fft_covers(n_fft):
        return False
    return n_fft <= fit_fullk_max_n_fft()


def angle_cap_bytes() -> int:
    return int(table()["streaming"]["angle_cap_bytes"])


def sinebank_cap_bytes() -> int:
    return int(table()["streaming"]["sinebank_cap_bytes"])


def batch_cap(mode: str) -> Optional[int]:
    """The largest batch a streaming session kernel of ``mode`` takes under
    ``auto`` (None: the kernel route won at every measured batch)."""
    cap = table()["streaming"]["batch_caps"][mode]
    return None if cap is None else int(cap)
