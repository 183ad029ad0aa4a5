"""Phase utilities: unwrapping, frame-axis finite differences and their exact
cumulative inverses (the Instantaneous Frequency machinery).

Twin of the JAX ``ops/phase.py``.  Everything works along the frame axis (-2)
with ``cumsum`` instead of loops.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "expi",
    "unwrap",
    "fdiff_forward",
    "fdiff_backward",
    "fdiff_central",
    "fint_forward",
    "fint_backward",
    "fint_central",
    "deriv",
    "get_fft_idx",
]


def expi(phase: torch.Tensor) -> torch.Tensor:
    """``e^{i phase}`` built as ``complex(cos, sin)`` of a real phase (a
    low-precision phase is computed in float32)."""
    phase = torch.as_tensor(phase)
    if phase.dtype not in (torch.float32, torch.float64):
        phase = phase.to(torch.float32)
    return torch.complex(torch.cos(phase), torch.sin(phase))


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """Numpy-style phase unwrapping along the frame axis (-2): jumps larger
    than pi are corrected by multiples of 2 pi; a jump of exactly -pi with a
    positive difference maps to +pi."""
    diff = p[..., 1:, :] - p[..., :-1, :]
    ddmod = torch.remainder(diff + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (diff > 0), math.pi, ddmod)
    ph_correct = torch.where(diff.abs() < math.pi, 0.0, ddmod - diff)
    return torch.cat([p[..., :1, :], p[..., 1:, :] + torch.cumsum(ph_correct, dim=-2)], dim=-2)


# "forward": out[0] = x[0], out[i] = (x[i] - x[i-1]) / 2
# "backward" = flip . forward . flip
# "central": out[0] = x[0], out[i] = (x[i+1] - x[i-1]) / 4, out[-1] = x[-1]


def fdiff_forward(x: torch.Tensor) -> torch.Tensor:
    d = (x[..., 1:, :] - x[..., :-1, :]) / 2.0
    return torch.cat([x[..., :1, :], d], dim=-2)


def fdiff_backward(x: torch.Tensor) -> torch.Tensor:
    return fdiff_forward(x.flip(-2)).flip(-2)


def fdiff_central(x: torch.Tensor) -> torch.Tensor:
    d = (x[..., 2:, :] - x[..., :-2, :]) / 4.0
    return torch.cat([x[..., :1, :], d, x[..., -1:, :]], dim=-2)


def fint_forward(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fdiff_forward`: y[0] = x[0], y[i] = y[i-1] + 2 x[i]."""
    scaled = torch.cat([x[..., :1, :], 2.0 * x[..., 1:, :]], dim=-2)
    return torch.cumsum(scaled, dim=-2)


def fint_backward(x: torch.Tensor) -> torch.Tensor:
    return fint_forward(x.flip(-2)).flip(-2)


def get_fft_idx(L: int, device=None) -> torch.Tensor:
    """Signed FFT bin indices of an ``L``-point transform."""
    if L % 2 == 0:
        idx = list(range(0, L // 2 + 1)) + list(range(-L // 2 + 1, 0))
    else:
        idx = list(range(0, (L + 1) // 2)) + list(range(-(L - 1) // 2, 0))
    return torch.tensor(idx, device=device)


def deriv(mag: torch.Tensor, order=2) -> torch.Tensor:
    """Periodic derivative along axis 0 of order 2, 4 or inf (spectral)."""
    L = mag.shape[0]
    if order == 2:
        return L * (torch.roll(mag, -1, dims=0) - torch.roll(mag, 1, dims=0)) / 2.0
    if order == 4:
        return L * (
            -torch.roll(mag, -2, dims=0)
            + 8.0 * torch.roll(mag, -1, dims=0)
            - 8.0 * torch.roll(mag, 1, dims=0)
            + torch.roll(mag, 2, dims=0)
        ) / 12.0
    if order == float("inf"):
        n = get_fft_idx(L, device=mag.device).to(torch.float32)
        n = n.reshape((L,) + (1,) * (mag.ndim - 1))
        spec = torch.fft.fft(mag, dim=0)
        return torch.real(2.0 * math.pi * torch.fft.ifft(1j * n * spec, dim=0))
    raise ValueError("order must be 2, 4 or inf")


def fint_central(x: torch.Tensor) -> torch.Tensor:
    """Cumulative inverse of :func:`fdiff_central` (two interleaved parity
    chains; interior rows satisfy ``y[i+1] = y[i-1] + 4 x[i]``).

    Even frame count: exact (the even chain integrates from ``x[0]``, the odd
    one from ``x[-1]``).  Odd frame count: both anchors land on the even
    chain, so the odd chain's constant offset is set by least squares against
    the midpoints of its even neighbours (the mean midpoint residual over all
    odd rows)."""
    T = x.shape[-2]
    if T <= 2:
        return x
    steps_even = 4.0 * x[..., 1::2, :]
    even_vals = x[..., :1, :] + torch.cumsum(steps_even, dim=-2)
    n_even = (T + 1) // 2
    even = torch.cat([x[..., :1, :], even_vals], dim=-2)[..., :n_even, :]

    out = torch.zeros_like(x)
    out[..., 0::2, :] = even
    if T % 2 == 1:
        steps_odd = 4.0 * x[..., 2:-1:2, :]
        z = torch.cat([torch.zeros_like(x[..., :1, :]), torch.cumsum(steps_odd, dim=-2)], dim=-2)
        z = z[..., : T // 2, :]
        mid = (even[..., :-1, :] + even[..., 1:, :]) / 2.0
        offset = torch.mean(mid - z, dim=-2, keepdim=True)
        out[..., 1::2, :] = z + offset
    else:
        back_steps = 4.0 * x[..., 1:-1, :].flip(-2)[..., ::2, :]
        back_vals = x[..., -1:, :] - torch.cumsum(back_steps, dim=-2)
        back = torch.cat([x[..., -1:, :], back_vals], dim=-2)[..., : T // 2, :]
        out[..., 1::2, :] = back.flip(-2)
    return out
