"""Mu-law companding (twin of the JAX ``ops/mulaw.py``).

Closed-form and elementwise.  Input is expected in [-1, 1] (the torchaudio
convention); codes are int32, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

__all__ = ["mulaw_encode", "mulaw_decode"]


def mulaw_encode(x: torch.Tensor, quantization_channels: int = 256) -> torch.Tensor:
    """Encode a [-1, 1] signal to integer mu-law codes in [0, channels).

    The cast truncates toward zero, as the JAX package's ``astype`` does; the
    argument is at least 0.5 there, so it rounds half up."""
    mu = quantization_channels - 1.0
    x = x.to(torch.float32)
    fx = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return ((fx + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mulaw_decode(codes: torch.Tensor, quantization_channels: int = 256) -> torch.Tensor:
    """Decode integer mu-law codes back to a [-1, 1] float32 signal."""
    mu = quantization_channels - 1.0
    x = codes.to(torch.float32)
    x = (x / mu) * 2.0 - 1.0
    return torch.sign(x) / mu * (torch.pow(1.0 + mu, torch.abs(x)) - 1.0)
