"""Scalar affine normalization with a statistics pass (twin of the JAX
``transforms/norm.py``).  ``offset`` and ``scale`` are 0-d buffers."""
from __future__ import annotations

from typing import Optional

import torch

from .base import AudioTransform

__all__ = ["Normalize"]

NORMALIZATION_MODES = ("unipolar", "bipolar", "gaussian")


class Normalize(AudioTransform):
    """Affine normalizer: ``forward = (x - offset) / scale``.

    Fitting modes:

    * ``unipolar`` -- min-max to [0, 1]
    * ``bipolar``  -- symmetric min-max to [-1, 1]
    * ``gaussian`` -- z-score (mean / unbiased std)
    """

    scriptable = True

    def __init__(self, mode: Optional[str] = "gaussian", sr: int = 44100, device=None):
        super().__init__(sr=sr, device=device)
        if mode is not None and mode not in NORMALIZATION_MODES:
            raise ValueError("unknown normalization mode %r" % mode)
        self.mode = mode
        self.needs_scaling = True
        self.register_buffer("offset", torch.zeros((), device=self.device))
        self.register_buffer("scale", torch.ones((), device=self.device))

    def get_normalization_modes(self):
        return list(NORMALIZATION_MODES)

    def fit(self, x: torch.Tensor, mask=None) -> "Normalize":
        """Fit stats on ``x``; with ``mask`` (broadcastable, 1 = real data)
        padded elements are excluded."""
        self._check(x)
        valid = None if mask is None else (mask > 0).expand(x.shape)
        inf = float("inf")

        def _min(v):
            return v.min() if valid is None else torch.where(valid, v, inf).min()

        def _max(v):
            return v.max() if valid is None else torch.where(valid, v, -inf).max()

        if self.mode == "unipolar":
            offset = _min(x)
            scale = _max(x - offset)
        elif self.mode == "bipolar":
            x_min, x_max = _min(x), _max(x)
            offset = (x_max + x_min) / 2.0
            scale = x_max - offset
        elif self.mode == "gaussian":
            if valid is None:
                offset = x.mean()
                scale = x.std(unbiased=True)
            else:
                n = valid.sum().to(x.dtype)
                offset = torch.where(valid, x, 0.0).sum() / n
                ss = torch.where(valid, (x - offset) ** 2, 0.0).sum()
                scale = torch.sqrt(ss / torch.clamp_min(n - 1.0, 1.0))
        else:  # mode None: identity
            offset = x.new_zeros(())
            scale = x.new_ones(())
        return self.with_stats(offset, scale)

    def with_stats(self, offset: torch.Tensor, scale: torch.Tensor) -> "Normalize":
        """Fitted copy holding the given statistics."""
        new = self.replace(
            offset=offset.detach().to(torch.float32).reshape(()),
            scale=scale.detach().to(torch.float32).reshape(()),
        )
        new.needs_scaling = False
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.offset) / self.scale

    def invert(self, x, inversion_mode=None, generator=None):
        return x * self.scale + self.offset
