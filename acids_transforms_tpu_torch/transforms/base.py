"""Core transform protocol: composable, invertible audio transforms as
``torch.nn.Module``s (twin of the JAX ``transforms/base.py``).

* Array state (windows, filterbanks, fitted normalizer statistics) are
  registered buffers, nested transforms are sub-modules, everything else
  (sample rate, mode strings, sizes) is plain attributes.
* ``fit(x)`` is pure: it returns a fitted copy.  ``scale_data(x)`` fits in
  place.
* Random inversion modes take an explicit ``torch.Generator`` where the JAX
  package takes a PRNG key.
* Every transform is built for one device (``device=None`` means ``"cuda"``
  and raises without a card); an input on another device raises.
* ``test_forward`` / ``test_inversion`` / ``test_jit_transform`` are the
  reference's self-describing smoke hooks; the twin of the JAX package's
  ``jforward`` in ``test_jit_transform`` is ``torch.jit.trace``.
* The streaming protocol: ``init_state`` / ``step`` / ``step_invert`` thread
  an explicit state through a chunked loop (``streaming.py``).  A chain's
  state is a list with one entry per child: a dict of tensors for a stateful
  child (``OverlapAdd``, ``RealtimeSTFT``), ``None`` for a stateless one.
  Where the JAX package splits a PRNG key per child and per chunk, the port
  threads one ``torch.Generator`` through the children in order: a child that
  draws nothing consumes nothing, so no per-child split has to be counted.
"""
from __future__ import annotations

import copy
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .._device import check_device, resolve_device

__all__ = [
    "AudioTransform",
    "ComposeAudioTransform",
    "NotInvertibleError",
    "InversionEnumType",
    "apply_transform_to_list",
    "apply_invert_transform_to_list",
]


class NotInvertibleError(Exception):
    """Raised when ``invert`` is called on a non-invertible transform."""


#: type of ``inversion_mode`` arguments
InversionEnumType = Optional[str]


class AudioTransform(nn.Module):
    """Base class for composable, invertible audio transforms.

    Capability flags:

    * ``invertible``  -- ``invert`` reconstructs the input (possibly phaseless).
    * ``scriptable``  -- forward/invert are static-shape tensor programs.
    * ``needs_scaling`` -- requires a ``fit``/``scale_data`` statistics pass
      before ``forward`` is meaningful.
    """

    invertible: bool = True
    scriptable: bool = True
    needs_scaling: bool = False

    def __init__(self, sr: int = 44100, device=None):
        super().__init__()
        self.sr = int(sr)
        self.device = resolve_device(device)

    def _check(self, x: torch.Tensor) -> None:
        check_device(x, self.device, "input of %s" % type(self).__name__)

    def replace(self, **updates) -> "AudioTransform":
        """Return a copy of this transform with the given attributes replaced."""
        new = copy.deepcopy(self)
        for k, v in updates.items():
            setattr(new, k, v)
        return new

    # ----------------------------------------------------------------- compose
    def __add__(self, other: "AudioTransform") -> "ComposeAudioTransform":
        if isinstance(other, ComposeAudioTransform):
            return ComposeAudioTransform(transforms=[self] + list(other.transforms))
        if isinstance(other, AudioTransform):
            return ComposeAudioTransform(transforms=[self, other])
        raise TypeError("AudioTransform cannot be added to type: %s" % type(other))

    # --------------------------------------------------------------------- api
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the transform (identity by default)."""
        return x

    def invert(
        self,
        x: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Invert the transform (identity by default)."""
        return x

    # ------------------------------------------------------------------ fitting
    def fit(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> "AudioTransform":
        """Pure fit: return a transform whose statistics are fitted on ``x``.
        Default: nothing to fit.  ``mask`` (broadcastable to ``x``; 1 = real
        data) excludes padding from the statistics."""
        return self

    def propagate_mask(self, mask: Optional[torch.Tensor], x: torch.Tensor):
        """Map a validity mask of the input ``x`` to the mask of the output
        (default: the transform preserves layout)."""
        return mask

    def scale_data(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> None:
        """In-place fit: runs :meth:`fit` and adopts the fitted state."""
        fitted = self.fit(x, mask=mask)
        if fitted is not self:
            self.__dict__.update(fitted.__dict__)

    @property
    def ratio(self) -> int:
        """Per-sample -> per-frame decimation factor."""
        return 1

    def output_frame_axis(self, axis_in: Optional[int] = None) -> Optional[int]:
        """Negative axis index of the frame dimension in this transform's
        output, given the frame axis of its input (``None``: no frame axis
        yet, or not representable).  Framing transforms (STFT, DGT, Window,
        OverlapAdd, MFCC) introduce it, layout transforms (Transpose,
        Squeeze, Unsqueeze, stacked representations) move it, everything
        else keeps it."""
        return axis_in

    def get_inversion_modes(self) -> Optional[List[str]]:
        return None

    def forward_with_time(self, x: torch.Tensor, time: torch.Tensor):
        """Forward pass threading per-chunk start times (default: unchanged)."""
        return self.forward(x), time

    # ---------------------------------------------------------------- streaming
    def realtime(self) -> "AudioTransform":
        """The streaming variant of this transform (default: itself)."""
        return self

    def init_state(self, batch_shape: Tuple[int, ...] = (), mode: Optional[str] = None,
                   generator: Optional[torch.Generator] = None):
        """Fresh streaming state (default: stateless, ``None``).  ``mode`` (an
        inversion-mode name) lets a stateful transform allocate only the carry
        that mode needs; ``generator`` drives a carry that is drawn (the
        sinebank's oscillator phases)."""
        return None

    def step(self, state, x: torch.Tensor):
        """One chunk of the streaming forward: ``(state, x) -> (state, y)``."""
        return state, self.forward(x)

    def step_invert(self, state, y: torch.Tensor, inversion_mode: Optional[str] = None,
                    generator: Optional[torch.Generator] = None):
        """One chunk of the streaming inverse: ``(state, y) -> (state, x)``."""
        return state, self.invert(y, inversion_mode=inversion_mode, generator=generator)

    #: every inversion-mode name any transform understands -- distinguishes
    #: "mode meant for another child in the chain" from a typo in
    #: :meth:`_resolve_mode`.  Open registry: see
    #: :meth:`register_inversion_modes`.
    _KNOWN_INVERSION_MODES = {
        "mono", "stereo", "crop",
        "griffin_lim", "keep_input", "random", "sinebank",
        "pghi", "pghi_bidir", "pghi_exact", "pghi_gl",
    }

    @classmethod
    def register_inversion_modes(cls, *modes: str) -> None:
        """Declare custom inversion-mode names as known, so that chains
        broadcast them past children that do not handle them."""
        AudioTransform._KNOWN_INVERSION_MODES.update(str(m) for m in modes)

    def _resolve_mode(self, inversion_mode: Optional[str]) -> Optional[str]:
        """Resolve a requested inversion mode against this transform's own.

        Chains broadcast one ``inversion_mode`` to every child; a mode that
        belongs to another transform type falls back to this transform's
        configured default.  A string no transform knows raises (typo
        protection)."""
        modes = self.get_inversion_modes() or []
        if inversion_mode is not None:
            if inversion_mode in modes:
                return inversion_mode
            if inversion_mode not in self._KNOWN_INVERSION_MODES:
                raise ValueError(
                    "inversion mode %r not valid (known: %s)"
                    % (inversion_mode, sorted(self._KNOWN_INVERSION_MODES))
                )
        return getattr(self, "inversion_mode", None)

    # ------------------------------------------------------------- test hooks
    # The reference's discovery-driven smoke hooks; transforms that need
    # other inputs (complex spectra, frames, integer codes) override them.
    def test_forward(self, x: torch.Tensor, time: Optional[torch.Tensor] = None):
        if self.needs_scaling:
            self.scale_data(x)
        if time is None:
            return self.forward(x)
        return self.forward_with_time(x, time)

    def test_inversion(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not self.invertible:
            raise NotImplementedError
        if self.needs_scaling:
            self.scale_data(x)
        return {"inverted": self.invert(self.forward(x))}

    def test_jit_transform(self, x: torch.Tensor, invert: bool = True):
        """The ``scriptable`` check: forward (and invert) must trace with
        ``torch.jit.trace`` and the traced forward runs on ``x``."""
        if self.needs_scaling:
            self.scale_data(x)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", torch.jit.TracerWarning)
            fwd = torch.jit.trace(lambda v: self.forward(v), (x,), check_trace=False)
            y = fwd(x)
            if invert and self.invertible:
                torch.jit.trace(lambda v: self.invert(v), (y,), check_trace=False)(y)
        return y

    def extra_repr(self) -> str:
        skip = {"training", "device"}
        return ", ".join(
            f"{k}={v!r}"
            for k, v in self.__dict__.items()
            if not k.startswith("_") and k not in skip
        )


class ComposeAudioTransform(AudioTransform):
    """Chain of transforms built with ``+``.

    * capability flags fold over children (AND for invertible/scriptable, OR
      for needs_scaling);
    * ``forward`` folds left, ``invert`` folds **right** with a shared
      ``inversion_mode`` handed to every child;
    * ``fit`` is the fit-then-advance cascade.
    """

    def __init__(self, transforms: Sequence[AudioTransform] = (), sr: int = 44100, device=None):
        transforms = list(transforms)
        if device is None and transforms:
            device = transforms[0].device
        super().__init__(sr=sr, device=device)
        for t in transforms:
            if t.device != self.device:
                raise ValueError(
                    "cannot compose transforms built for different devices "
                    "(%s and %s)" % (self.device, t.device)
                )
        self.transforms = nn.ModuleList(transforms)
        self._register_child_modes()

    def _register_child_modes(self) -> None:
        # a shared mode string broadcast by invert() must be recognized by
        # siblings that do not own it
        for t in self.transforms:
            modes = t.get_inversion_modes()
            if modes and isinstance(modes[0], str):
                AudioTransform._KNOWN_INVERSION_MODES.update(modes)

    @property
    def invertible(self) -> bool:
        return all(t.invertible for t in self.transforms)

    @property
    def scriptable(self) -> bool:
        return all(t.scriptable for t in self.transforms)

    @property
    def needs_scaling(self) -> bool:
        return any(t.needs_scaling for t in self.transforms)

    def __getitem__(self, item):
        return self.transforms[item]

    def __len__(self):
        return len(self.transforms)

    def __add__(self, other):
        if not isinstance(other, AudioTransform):
            raise TypeError("ComposeAudioTransform can only be added to other AudioTransforms")
        if isinstance(other, ComposeAudioTransform):
            return ComposeAudioTransform(list(self.transforms) + list(other.transforms))
        return ComposeAudioTransform(list(self.transforms) + [other])

    def __radd__(self, other):
        if not isinstance(other, AudioTransform):
            raise TypeError("ComposeAudioTransform can only be added to other AudioTransforms")
        if isinstance(other, ComposeAudioTransform):
            return ComposeAudioTransform(list(other.transforms) + list(self.transforms))
        return ComposeAudioTransform([other] + list(self.transforms))

    @property
    def ratio(self) -> int:
        ratio = 1
        for t in self.transforms:
            ratio = ratio * t.ratio
        return ratio

    def fit(self, x: torch.Tensor, mask=None) -> "ComposeAudioTransform":
        fitted = []
        for t in self.transforms:
            t = t.fit(x, mask=mask)
            fitted.append(t)
            mask = t.propagate_mask(mask, x)
            x = t.forward(x)
        return ComposeAudioTransform(transforms=fitted, sr=self.sr, device=self.device)

    def propagate_mask(self, mask, x):
        for t in self.transforms:
            mask = t.propagate_mask(mask, x)
            x = t.forward(x)
        return mask

    def scale_data(self, x: torch.Tensor, mask=None) -> None:
        for t in self.transforms:
            t.scale_data(x, mask=mask)
            mask = t.propagate_mask(mask, x)
            x = t.forward(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for t in self.transforms:
            x = t.forward(x)
        return x

    def invert(self, x, inversion_mode=None, generator=None):
        self._register_child_modes()
        for t in reversed(list(self.transforms)):
            x = t.invert(x, inversion_mode=inversion_mode, generator=generator)
        return x

    def get_inversion_modes(self, idx: Optional[int] = None):
        if idx is None:
            return [t.get_inversion_modes() for t in self.transforms]
        return self.transforms[idx].get_inversion_modes()

    def forward_with_time(self, x, time):
        for t in self.transforms:
            x, time = t.forward_with_time(x, time)
        return x, time

    def output_frame_axis(self, axis_in: Optional[int] = None) -> Optional[int]:
        for t in self.transforms:
            axis_in = t.output_frame_axis(axis_in)
        return axis_in

    # -------------------------------------------------------------- streaming
    def realtime(self) -> "ComposeAudioTransform":
        return ComposeAudioTransform([t.realtime() for t in self.transforms], sr=self.sr,
                                     device=self.device)

    def init_state(self, batch_shape: Tuple[int, ...] = (), mode: Optional[str] = None,
                   generator: Optional[torch.Generator] = None):
        """Left to right, the one ``generator`` handed to every child."""
        return [t.init_state(batch_shape, mode=mode, generator=generator) for t in self.transforms]

    def step(self, state, x):
        new_states = []
        for t, st in zip(self.transforms, state):
            st, x = t.step(st, x)
            new_states.append(st)
        return new_states, x

    def step_invert(self, state, y, inversion_mode=None, generator=None):
        """Right to left, the one ``generator`` handed to every child."""
        self._register_child_modes()
        new_states = list(state)
        for i in range(len(self.transforms) - 1, -1, -1):
            new_states[i], y = self.transforms[i].step_invert(
                state[i], y, inversion_mode=inversion_mode, generator=generator
            )
        return new_states, y


def apply_transform_to_list(transform, data, time=None, **kwargs):
    """Map a transform over a Python list of tensors (with ``time``: a list
    of start times, mapped through ``forward_with_time``)."""
    if time is None:
        return [transform(d, **kwargs) for d in data]
    outs = [transform.forward_with_time(d, t) for d, t in zip(data, time)]
    return [o[0] for o in outs], [o[1] for o in outs]


def apply_invert_transform_to_list(transform, data, time=None, **kwargs):
    """Map a transform's inverse over a Python list of tensors (``time``
    passes through)."""
    outs = [transform.invert(d, **kwargs) for d in data]
    if time is None:
        return outs
    return outs, list(time)
