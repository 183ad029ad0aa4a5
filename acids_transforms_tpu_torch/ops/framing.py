"""Framing / overlap-add primitives (twin of the JAX ``ops/framing.py``).

Frames are built from hop-aligned shifted slices when ``hop`` divides the
window, else from a gather; overlap-add is ``overlap`` dense shifted adds, no
scatter, so the result does not depend on an atomics order.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["frame", "overlap_add", "pad_axis", "num_frames", "reshape_batches"]


def num_frames(length: int, wsize: int, hsize: int) -> int:
    """Number of frames :func:`frame` produces (tail zero-padded)."""
    return max((int(length) - int(wsize)) // int(hsize), 0) + 1


def pad_axis(x: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to ``target``."""
    axis = axis % x.ndim
    size = x.shape[axis]
    if size >= target:
        return x
    pads = [0, 0] * x.ndim
    # F.pad counts dimensions from the last one
    pads[2 * (x.ndim - 1 - axis) + 1] = target - size
    return F.pad(x, pads)


def frame(x: torch.Tensor, wsize: int, hsize: int, axis: int = -1) -> torch.Tensor:
    """Slice ``x`` into overlapping frames along ``axis``:
    ``(..., L, ...) -> (..., n_frames, wsize, ...)``."""
    wsize, hsize = int(wsize), int(hsize)
    axis = axis % x.ndim
    n = num_frames(x.shape[axis], wsize, hsize)
    x = pad_axis(x, (n - 1) * hsize + wsize, axis)

    if wsize % hsize == 0:
        overlap = wsize // hsize
        total = (n - 1 + overlap) * hsize
        x = pad_axis(x, total, axis).narrow(axis, 0, total)
        chunks = x.reshape(x.shape[:axis] + (total // hsize, hsize) + x.shape[axis + 1:])
        return torch.cat(
            [chunks.narrow(axis, j, n) for j in range(overlap)], dim=axis + 1
        )

    idx = (
        torch.arange(n, device=x.device)[:, None] * hsize
        + torch.arange(wsize, device=x.device)[None, :]
    )
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + (n, wsize) + x.shape[axis + 1:])


def overlap_add(frames: torch.Tensor, hsize: int) -> torch.Tensor:
    """Overlap-add frames ``(..., T, W)`` into ``(..., (T-1)*hop + W)``."""
    hsize = int(hsize)
    T, W = frames.shape[-2], frames.shape[-1]
    out_len = (T - 1) * hsize + W
    overlap = -(-W // hsize)
    frames = pad_axis(frames, overlap * hsize, -1)
    chunks = frames.reshape(frames.shape[:-1] + (overlap, hsize))
    total_chunks = T + overlap - 1
    out = frames.new_zeros(frames.shape[:-2] + (total_chunks, hsize))
    for j in range(overlap):
        out[..., j: j + T, :] += chunks[..., :, j, :]
    return out.reshape(frames.shape[:-2] + (total_chunks * hsize,))[..., :out_len]


def reshape_batches(x: torch.Tensor, event_ndim: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Flatten all leading batch dims before the last ``event_ndim`` dims.

    Returns ``(flat, batch_shape)``."""
    event_ndim = int(event_ndim)
    if event_ndim == 0:
        return x.reshape(-1), tuple(x.shape)
    batch_shape = tuple(x.shape[:-event_ndim])
    return x.reshape((-1,) + tuple(x.shape[-event_ndim:])), batch_shape
