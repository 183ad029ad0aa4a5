"""OverlapAdd: the streaming framing / overlap-add state machine (twin of the
JAX ``transforms/oadd.py``).

* The ring buffers (``input_buffer``, the previous chunk's tail; and
  ``output_buffer``, the overlap-add tail not emitted yet) are explicit
  state: ``init_state`` / ``step`` / ``step_invert`` take and return it, for
  the chunked loops of ``streaming.py``.  The eager ``forward`` / ``invert``
  keep it on ``self``.
* ``gain_compensation`` is exactly ``n_fft // hop`` (a sample's number of
  covering frames), so ``invert(forward(x))`` is unity-gain in the steady
  state; with the dual-window synthesis of ``RealtimeSTFT`` / ``RealtimeDGT``
  the whole streaming chain reconstructs at unity, delayed by ``(n_fft //
  hop - 1) * hop`` samples.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.framing import frame, overlap_add
from .base import AudioTransform

__all__ = ["OverlapAdd"]

State = Dict[str, torch.Tensor]


class OverlapAdd(AudioTransform):
    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(self, n_fft: int = 1024, hop_length: int = 128, dim: int = -1, sr: int = 44100,
                 device=None):
        super().__init__(sr=sr, device=device)
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        if self.n_fft % self.hop_length != 0:
            raise ValueError("OverlapAdd requires hop_length to divide n_fft")
        if int(dim) != -1:
            # the reference accepts `dim` but works on the last axis only
            raise ValueError(
                "OverlapAdd only supports dim=-1 (the sample axis); move your "
                "data axis with torch.movedim first"
            )
        self.dim = int(dim)
        self.frames_out = self.n_fft // self.hop_length - 1
        self._state: Optional[State] = None

    @property
    def gain_compensation(self) -> float:
        return float(self.n_fft // self.hop_length)

    @property
    def _carry(self) -> int:
        """Ring-buffer length in samples."""
        return self.frames_out * self.hop_length

    def output_frame_axis(self, axis_in=None):
        return -2  # (..., frames, n_fft)

    def propagate_mask(self, mask, x):
        """Sample mask -> per-frame mask ``(..., T, 1)``: the chunk is behind
        the carried ring (assumed valid), frame t starts at ``t hop - carry``."""
        if mask is None:
            return None
        T = max((self._carry + x.shape[-1] - self.n_fft) // self.hop_length, 0) + 1
        starts = torch.clamp(
            torch.arange(T, device=mask.device) * self.hop_length - self._carry, 0, mask.shape[-1] - 1
        )
        return mask.index_select(-1, starts)[..., :, None]

    # ------------------------------------------------------------------ state
    def init_state(self, batch_shape: Tuple[int, ...] = (), mode: Optional[str] = None,
                   generator: Optional[torch.Generator] = None) -> State:
        shape = tuple(batch_shape) + (self._carry,)
        return {
            "input_buffer": torch.zeros(shape, device=self.device),
            "output_buffer": torch.zeros(shape, device=self.device),
        }

    def reset(self, batch_shape: Tuple[int, ...] = ()) -> None:
        """Fresh eager ring buffers for ``batch_shape``."""
        self._state = self.init_state(tuple(batch_shape))

    # ------------------------------------------------------------- pure steps
    def step(self, state: State, x: torch.Tensor) -> Tuple[State, torch.Tensor]:
        """``(state, chunk (..., C)) -> (state, frames (..., C / hop, n_fft))``:
        the carried tail of the previous chunk leads, so frames straddle chunk
        boundaries."""
        self._check(x)
        carry = self._carry
        xc = torch.cat([state["input_buffer"], x.to(state["input_buffer"].dtype)], dim=-1)
        frames = frame(xc, self.n_fft, self.hop_length, -1)
        new_state = dict(state)
        if carry > 0:
            new_state["input_buffer"] = xc[..., -carry:]
        return new_state, frames

    def step_invert(self, state: State, frames: torch.Tensor, inversion_mode: Optional[str] = None,
                    generator: Optional[torch.Generator] = None) -> Tuple[State, torch.Tensor]:
        """``(state, frames (..., T, n_fft)) -> (state, chunk (..., T hop))``:
        overlap-add with the carried tail, divided by the frame multiplicity."""
        carry = self._carry
        ola = overlap_add(frames, self.hop_length)  # (..., (T - 1) hop + n_fft)
        new_state = dict(state)
        if carry > 0:
            head = ola[..., :carry] + state["output_buffer"]
            ola = torch.cat([head, ola[..., carry:]], dim=-1)
            new_state["output_buffer"] = ola[..., -carry:]
            ola = ola[..., :-carry]
        return new_state, ola / self.gain_compensation

    # --------------------------------------------------------- eager wrappers
    def _eager_state(self, batch_shape) -> State:
        st = self._state
        if st is None or tuple(st["input_buffer"].shape[:-1]) != tuple(batch_shape):
            st = self.init_state(tuple(batch_shape))
        return st

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        new_state, frames = self.step(self._eager_state(x.shape[:-1]), x)
        self._state = new_state
        return frames

    def forward_with_time(self, x, time):
        frames = self.forward(x)
        shifts = torch.arange(frames.shape[-2], device=frames.device, dtype=torch.float32) * (
            self.hop_length / self.sr
        )
        return frames, shifts + time[..., None]

    def invert(self, x, inversion_mode=None, generator=None):
        new_state, out = self.step_invert(self._eager_state(x.shape[:-2]), x)
        self._state = new_state  # the input ring is kept
        return out

    def extra_repr(self) -> str:
        return "n_fft=%d, hop_length=%d" % (self.n_fft, self.hop_length)
