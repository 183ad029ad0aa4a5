"""Linear resampling as ``torch.nn.functional.interpolate(mode="linear",
align_corners=False)`` computes it (twin of the JAX ``ops/interp.py``): the
sinebank inversion's envelope upsampling.

A gather and a lerp with index tables built in numpy, batched over the
leading dims.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["interp_linear"]


def _tables(in_size: int, out_size: int):
    """``(lo, hi, w_hi)``: the two source samples of each output sample and
    the weight of the upper one, in float64 then rounded to float32 as the
    JAX package builds them."""
    scale = in_size / out_size
    src = np.clip((np.arange(out_size) + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def interp_linear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resample the last axis of ``x`` to ``out_size`` samples, half-pixel
    (``align_corners=False``):
    ``src = clamp((dst + 0.5) * in / out - 0.5, 0, in - 1)``."""
    lo, hi, w = _tables(x.shape[-1], out_size)
    lo_t = torch.as_tensor(lo, device=x.device)
    hi_t = torch.as_tensor(hi, device=x.device)
    w_t = torch.as_tensor(w, device=x.device)
    # two buffers of the output's size at most: the products run in place
    return x.index_select(-1, lo_t).mul_(1.0 - w_t).add_(x.index_select(-1, hi_t).mul_(w_t))
