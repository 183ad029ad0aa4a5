"""Auto-dispatch region table of the port (twin of the JAX ``regions.py``).

``backend="auto"`` takes a hand-written kernel only inside the region where
it was measured faster than the route ``auto`` would otherwise run, and a
streaming session kernel only up to its measured batch cap and memory
footprint.  Every numeric gate loads from ``dispatch_regions.json`` beside
this module, measured on the H100 by ``tools/sweep_regions.py``; each value
carries a ``_why`` with the card, its power limit and the ratios measured.
None comes from the JAX package's table, whose values are TPU crossovers.

A shape region is ``n_fft_min <= n_fft <= n_fft_max`` and the list
``routes`` of the kernel routes it admits (:func:`kernel_route`): ``"fft"``
(the shared-memory FFT, ``n_fft`` a power of two, 64-4096), ``"smooth"`` (the
mixed-radix FFT at an even ``n_fft`` that is no power of two: 5-smooth for
every kernel of these regions, A, B, E, F, G and H, and 7-smooth with a
factor 7 for the magnitude kernels A, B, E and F, whose radix-7 instance G
and H lack) and ``"product"`` / ``"factored"`` (the full-K and the
cosine-sum front ends everywhere else).  A route is listed only where every
point of it the sweep measured won against the eager route: for the
magnitude patterns 768/192 and 896/224 (2^7 7) measure the smooth route and
1408/352 (2^7 11) the factored and product routes; for the representations
768/192 the smooth route and 896/224 the factored and product routes.  A
region has no overlap bound: the
kernels' own gate (2 <= n_fft / hop <= 8) is the whole range, and the kernel
won at each overlap measured, so the functions take ``hop_length`` for the
JAX package's signatures only.
A region that is None holds no shape.  The tests
(``tests/test_torch_regions.py``) hold the planners' live decisions against
stated expectations.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Optional

from .ops.cuda.spectral import melspec_route

__all__ = [
    "table",
    "kernel_route",
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


def kernel_route(n_fft: int, has_taps: bool, family: str) -> str:
    """The route a kernel of these regions takes at ``n_fft``: the
    ``family``'s (``"melspec"``: A, B, E, F; ``"repr"``: G, H)
    ``ops/cuda/spectral.py:melspec_route`` ``"fft"`` or ``"smooth"``, else
    ``"factored"`` with cosine-sum taps and ``"product"`` without."""
    route = melspec_route(n_fft, family)
    if route != "other":
        return route
    return "factored" if has_taps else "product"


def _in_shape_region(r: Optional[dict], n_fft: int, route: str) -> bool:
    if r is None:
        return False
    return route in r["routes"] and r["n_fft_min"] <= n_fft <= r["n_fft_max"]


def melspec_region_ok(n_fft: int, hop_length: int, has_taps: bool) -> bool:
    """The fused log-mel / magnitude forward: A with cosine-sum taps, E for
    any other window (the DGT's gaussian)."""
    t = table()["fuse_forward"]
    return _in_shape_region(t["melspec_taps" if has_taps else "melspec_fullk"], n_fft,
                            kernel_route(n_fft, has_taps, "melspec"))


def repr_region_ok(n_fft: int, hop_length: int, has_taps: bool, second: str) -> bool:
    """The two-channel forward G: PolarIF (``second == "if"``) has its own
    region, Polar and Cartesian share one; each with taps and full-K."""
    r = table()["fuse_forward"]["repr_if" if second == "if" else "repr_phase_imag"]
    return _in_shape_region(r["taps" if has_taps else "fullk"], n_fft,
                            kernel_route(n_fft, has_taps, "repr"))


def mfcc_region_ok(n_fft: int, hop_length: int) -> bool:
    return _in_shape_region(table()["fuse_forward"]["mfcc"], n_fft, kernel_route(n_fft, True, "melspec"))


def fit_fullk_max_n_fft() -> int:
    return int(table()["fuse_fit"]["fullk_n_fft_max"])


def fit_fullk_region_ok(n_fft: int, two_channel: bool = False) -> bool:
    """The one-pass fit of a window without taps up to its measured largest
    n_fft, on the routes its family won (``"fft"``, ``"smooth"``,
    ``"product"``): the magnitude's (F) or, with ``two_channel``, the
    representations' (H full-K)."""
    t = table()["fuse_fit"]
    routes = t["repr_fullk_routes" if two_channel else "melspec_fullk_routes"]
    return (kernel_route(n_fft, False, "repr" if two_channel else "melspec") in routes
            and n_fft <= fit_fullk_max_n_fft())


def angle_cap_bytes() -> int:
    return int(table()["streaming"]["angle_cap_bytes"])


def sinebank_cap_bytes() -> int:
    return int(table()["streaming"]["sinebank_cap_bytes"])


def batch_cap(mode: str) -> Optional[int]:
    """The largest batch a streaming session kernel of ``mode`` takes under
    ``auto`` (None: the kernel route won at every measured batch)."""
    cap = table()["streaming"]["batch_caps"][mode]
    return None if cap is None else int(cap)
