"""Variable-length audio at a few fixed shapes: pad-to-bucket + mask (twin
of the JAX ``utils/bucketing.py``).

A server that sees arbitrary lengths would hand the chain a new shape per
request; quantizing lengths to a small ladder of buckets, zero-padding up and
carrying a sample mask keeps the set of shapes small and known ahead of time
(``serving.CompiledTransform``).  Everything stays on the input's device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["default_buckets", "pad_to_bucket", "frame_mask"]


def default_buckets(
    min_seconds: float = 0.25, max_seconds: float = 60.0, sr: int = 44100, factor: float = 1.5
) -> Tuple[int, ...]:
    """Geometric bucket ladder in samples (each ~``factor`` x the previous)."""
    out = []
    n = int(min_seconds * sr)
    stop = int(max_seconds * sr)
    while n < stop:
        out.append(n)
        n = int(n * factor)
    out.append(stop)
    return tuple(out)


def pad_to_bucket(
    x: torch.Tensor, buckets: Sequence[int] = ()
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Zero-pad the last axis of ``x`` up to the smallest bucket >= its length
    (past the ladder: the next multiple of its largest bucket).

    Returns ``(padded, mask, bucket)`` where ``mask (..., bucket)`` is 1.0
    over real samples, both on ``x``'s device."""
    if not buckets:
        buckets = default_buckets()
    L = x.shape[-1]
    fitting = [b for b in buckets if b >= L]
    bucket = min(fitting) if fitting else -(-L // buckets[-1]) * buckets[-1]
    padded = torch.nn.functional.pad(x, (0, bucket - L))
    mask = torch.zeros(tuple(x.shape[:-1]) + (bucket,), dtype=torch.float32, device=x.device)
    mask[..., :L] = 1.0
    return padded, mask, int(bucket)


def frame_mask(sample_mask: torch.Tensor, wsize: int, hsize: int) -> torch.Tensor:
    """Downsample a sample mask to a per-frame validity mask: a frame is valid
    iff its *first* sample is real (the framing's tail-padding convention)."""
    n = max((sample_mask.shape[-1] - wsize) // hsize, 0) + 1
    starts = torch.arange(n, device=sample_mask.device) * hsize
    return sample_mask.index_select(-1, starts)
