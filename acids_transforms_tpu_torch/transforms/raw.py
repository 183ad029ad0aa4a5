"""Raw-domain transforms (twin of the JAX ``transforms/raw.py``).  Only
``Mono`` is ported; ``Stereo``, ``MidSide``, ``Window`` and ``MuLaw`` wait
(ROADMAP Queue 1 item 6)."""
from __future__ import annotations

from typing import List

import torch

from .base import AudioTransform

__all__ = ["Mono"]


class Mono(AudioTransform):
    """Stereo -> mono via ``mix`` / ``left`` / ``right``."""

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(
        self,
        mode: str = "mix",
        normalize: bool = False,
        squeeze: bool = True,
        inversion_mode: str = "mono",
        sr: int = 44100,
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        if mode not in ("mix", "left", "right"):
            raise ValueError("unknown mono mode %r" % mode)
        self.mode = mode
        self.normalize = bool(normalize)
        self.squeeze = bool(squeeze)
        self.inversion_mode = inversion_mode

    def get_inversion_modes(self) -> List[str]:
        return ["mono", "stereo"]

    def forward(self, x):
        if isinstance(x, list):
            return [self.forward(v) for v in x]
        self._check(x)
        if x.ndim >= 2 and x.shape[-2] == 2:
            if self.mode == "mix":
                x = (x.sum(-2) / 2.0)[..., None, :]
            elif self.mode == "right":
                x = x[..., 1:2, :]
            else:
                x = x[..., 0:1, :]
        if self.normalize:
            # divides by the SIGNED max, not abs().max(): behaviour kept from
            # the JAX package (its PARITY.md documents the quirk)
            x = x / x.max()
        if self.squeeze and x.ndim >= 2 and x.shape[-2] == 1:
            x = x.squeeze(-2)
        return x

    def propagate_mask(self, mask, x):
        """A channel-free sample mask (ndim = x.ndim - 1) survives the channel
        mix/squeeze unchanged; a mask carrying the channel axis is reduced the
        same way the signal is."""
        if mask is None:
            return None
        if mask.ndim < x.ndim:
            return mask
        if mask.ndim >= 2 and mask.shape[-2] == 2:
            mask = mask.amax(-2)[..., None, :]
        if self.squeeze and mask.ndim >= 2 and mask.shape[-2] == 1:
            mask = mask.squeeze(-2)
        return mask

    def invert(self, x, inversion_mode=None, generator=None):
        mode = self._resolve_mode(inversion_mode)
        if self.squeeze:
            x = x[..., None, :]
        if x.shape[-2] == 1 and mode == "stereo":
            x = torch.cat([x, x], dim=-2)
        return x
