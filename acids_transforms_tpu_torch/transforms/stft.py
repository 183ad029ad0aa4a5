"""STFT transform pair: offline and per-frame streaming (twin of the JAX
``transforms/stft.py``).

``STFT`` ported: forward, the complex least-squares inversion and the
phaseless modes ``griffin_lim``, ``pghi``, ``pghi_bidir``, ``pghi_exact``,
``pghi_gl``, ``random`` and ``keep_input``; on a CUDA tensor ``griffin_lim``
and ``pghi_gl`` run the Griffin-Lim kernels of ``ops/cuda/glstep.py``.
``sinebank`` raises ``NotImplementedError`` until its slice (ROADMAP Queue 1
item 8).

``RealtimeSTFT`` ported: the per-frame forward, the dual-window synthesis and
the streaming inversion (``init_state`` / ``step_invert``) of the complex
spectrum and of the modes ``keep_input``, ``random``, ``pghi`` (causal
RT-PGHI carrying two magnitude frames and one phase frame; ``pghi_exact`` maps
to it, there is no heap online) and ``pghi_gl`` (the RT-PGHI seed polished by
``gl_iterations`` windowed consistency projections with ``gl_context``
committed frames pinned, optionally ``lookahead_frames`` of delayed commit).
Its streaming mode ``sinebank`` (and its carried state) raises
``NotImplementedError`` until its slice (ROADMAP Queue 1 item 9b(ii)).

The PGHI modes work on any named window through its effective
time-frequency ratio (``gamma``).  On a CUDA tensor ``pghi`` / ``pghi_bidir``
launch the kernels of ``ops/cuda/pghi_kernel.py`` where they cover the
shape or the JAX package's structural gates hold (raising where a kernel's
limit bites), and run the recurrence kernel or ``pghi_scan`` with the ISTFT
elsewhere (``pghi_kernel.pghi_dispatch``), as the JAX package does on a TPU;
on a CPU tensor they run ``ops/pghi.py:pghi_scan`` and
the ISTFT (both as the causal scan: the bidirectional order exists for the
card).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.fft import irfft_frames, istft, rfft_frames, stft as stft_op, taps_for_window
from ..ops.framing import frame, overlap_add
from ..ops.griffinlim import griffin_lim
from ..ops.pghi import pghi_heap_numpy, pghi_scan, random_angles
from ..ops.windows import dual_window, get_window, window_gamma
from .base import AudioTransform

__all__ = ["STFT", "RealtimeSTFT"]

_UNPORTED_MODES = {"sinebank": "Queue 1 item 8 (needs ops/interp.py)"}
#: streaming modes whose carried state comes with a later slice
_UNPORTED_STREAM_MODES = {
    "sinebank": "Queue 1 item 9b(ii) (sinebank_stream)",
}
#: streaming modes that carry the RT-PGHI frame history
_PGHI_STREAM_MODES = ("pghi", "pghi_exact", "pghi_gl")


class STFT(AudioTransform):
    """Offline STFT with phaseless inversion.

    Inversion modes: ``griffin_lim`` (default), ``keep_input``, ``random``
    and the PGHI family (``pghi``, ``pghi_bidir``, ``pghi_exact``,
    ``pghi_gl``); ``sinebank`` is a known name that raises
    ``NotImplementedError`` for now.
    """

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(
        self,
        sr: int = 44100,
        n_fft: int = 1024,
        hop_length: int = 256,
        inversion_mode: str = "griffin_lim",
        window: str = "hann",
        impl: str = "auto",
        seed: int = 0,
        gl_iterations: int = 30,
        gl_momentum: float = 0.99,
        tolerance: float = 1e-2,
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        self.window_name = window
        self.impl = impl
        self.gl_iterations = int(gl_iterations)
        self.gl_momentum = float(gl_momentum)
        self.tolerance = float(tolerance)
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        self.seed = int(seed)
        self._draws = 0
        self._phase_buffer = None
        self._refresh_windows()
        if inversion_mode not in self.get_inversion_modes():
            raise ValueError("Inversion mode %s not known" % inversion_mode)
        self.inversion_mode = inversion_mode

    # ------------------------------------------------------------- parameters
    def _get_window(self) -> torch.Tensor:
        return get_window(self.window_name, self.n_fft, device=self.device)

    def _get_inv_window(self) -> torch.Tensor:
        # the offline ISTFT divides by the squared-window envelope, so
        # synthesis = analysis gives the exact least-squares inverse
        return self._get_window()

    def _refresh_windows(self) -> None:
        for name, w in (("window", self._get_window()), ("inv_window", self._get_inv_window())):
            if name in self._buffers:
                self._buffers[name] = w
            else:
                self.register_buffer(name, w)
        self._refresh_taps()

    def _refresh_taps(self) -> None:
        """Cosine-sum spectral taps of the two windows (None otherwise):
        consumed by ``impl="factored"`` and by the fused kernels' dispatch."""
        self._window_taps = taps_for_window(self.window)
        self._inv_window_taps = taps_for_window(self.inv_window)

    def set_params(self, n_fft: int, hop_length: int) -> None:
        """Reconfigure in place (rebuilds the window buffers)."""
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        self._refresh_windows()

    @property
    def gamma(self) -> float:
        """Effective time-frequency ratio for the PGHI phase gradients: for a
        non-Gaussian analysis window the per-window constant times ``n_fft^2``
        (``ops/windows.py:window_gamma``), which lets PGHI work on plain STFTs."""
        return window_gamma(self.window_name, self.n_fft)

    @property
    def ratio(self) -> int:
        return self.hop_length

    def output_frame_axis(self, axis_in=None):
        return -2  # (..., frames, bins)

    def propagate_mask(self, mask, x):
        """Sample mask (..., L) -> frame mask (..., T, 1): a frame is real iff
        the sample at its hop-start is real."""
        if mask is None:
            return None
        T = x.shape[-1] // self.hop_length + 1
        starts = torch.clamp(
            torch.arange(T, device=mask.device) * self.hop_length, 0, mask.shape[-1] - 1
        )
        return mask.index_select(-1, starts)[..., :, None]

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    # ---------------------------------------------------------------- modes
    @staticmethod
    def get_inversion_modes() -> List[str]:
        return ["griffin_lim", "keep_input", "random", "sinebank", "pghi", "pghi_bidir", "pghi_gl", "pghi_exact"]

    def set_inversion_mode(self, inversion_mode: str) -> None:
        if inversion_mode not in self.get_inversion_modes():
            raise ValueError("inversion mode %s not valid" % inversion_mode)
        self.inversion_mode = inversion_mode

    # -------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(..., L) -> complex (..., T, n_fft//2 + 1)``."""
        self._check(x)
        spec = stft_op(
            x, self.n_fft, self.hop_length, self.window, impl=self.impl,
            taps=self._window_taps,
        )
        self._stash_phase(spec)
        return spec

    def forward_with_time(self, x: torch.Tensor, time: torch.Tensor):
        spec = self.forward(x)
        shifts = torch.arange(spec.shape[-2], device=spec.device, dtype=torch.float32) * (
            self.hop_length / self.sr
        )
        return spec, shifts + time[..., None]

    # ---------------------------------------------------------------- invert
    def invert(
        self,
        x: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        init_phase: Optional[torch.Tensor] = None,
        phase: Optional[torch.Tensor] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        self._check(x)
        if not x.is_complex():
            return self.invert_without_phase(
                x, inversion_mode, generator=generator, init_phase=init_phase,
                phase=phase, angles=angles,
            )
        return istft(
            x, self.n_fft, self.hop_length, self.inv_window, impl=self.impl,
            taps=self._inv_window_taps,
        )

    def invert_without_phase(
        self,
        mag: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        init_phase: Optional[torch.Tensor] = None,
        phase: Optional[torch.Tensor] = None,
        tolerance: Optional[float] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Audio from magnitudes ``(..., T, F)``.  ``generator`` drives every
        random draw of the mode (none given: one derived from ``seed`` and the
        number of draws so far); ``angles`` pins the PGHI modes' silent-bin
        phases; ``phase`` is ``keep_input``'s explicit phase."""
        mode = self._resolve_mode(inversion_mode)
        if mode == "griffin_lim":
            return self.griffin_lim(mag, generator=generator, init_phase=init_phase)
        if mode in ("pghi", "pghi_bidir"):
            from ..ops.cuda.pghi_kernel import pghi_dispatch

            if mag.is_cuda and pghi_dispatch(mode, self.n_fft, self.hop_length) == "fused":
                from ..ops.cuda.pghi_kernel import pghi_invert_bidir, pghi_invert_fused

                invert = pghi_invert_fused if mode == "pghi" else pghi_invert_bidir
                return invert(
                    mag, self.gamma, self.n_fft, self.hop_length, self.inv_window,
                    tolerance=self._tol(tolerance), angles=self._angles(mag, generator, angles),
                )
            ph = self.pghi(mag, tolerance=tolerance, generator=generator, angles=angles)
            return self.invert(torch.polar(mag, ph))
        if mode == "pghi_exact":
            return self.invert(torch.polar(mag, self.pghi_exact(mag, tolerance=tolerance)))
        if mode == "pghi_gl":
            # PGHI seeds the projection iteration; on a CUDA tensor the loop
            # runs the factored step for a cosine-sum window and the full-K
            # step for any other (the DGT's gaussian), ops/griffinlim.py
            ph = self.pghi(mag, tolerance=tolerance, generator=generator, angles=angles)
            return self.griffin_lim(mag, init_phase=ph)
        if mode in ("keep_input", "random"):
            if mode == "keep_input" and phase is None:
                phase = self._recall_phase(mag)
            if mode == "random" or phase is None:
                phase = self._angles(mag, generator, None)
            return self.invert(torch.polar(mag, phase.to(mag.dtype)))
        if mode in _UNPORTED_MODES:
            raise NotImplementedError(
                "STFT inversion mode %r is not ported yet (ROADMAP %s)"
                % (mode, _UNPORTED_MODES[mode])
            )
        raise ValueError("inversion mode %s not valid." % mode)

    def _next_generator(self) -> torch.Generator:
        """A generator for one random draw: a function of ``seed`` and of how
        many draws this transform has made, so repeated calls differ."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + self._draws)
        self._draws += 1
        return g

    def _tol(self, tolerance: Optional[float]) -> float:
        return float(self.tolerance if tolerance is None else tolerance)

    def _angles(self, mag, generator, angles) -> torch.Tensor:
        """Random phases for ``mag``'s bins unless ``angles`` pins them."""
        if angles is not None:
            return angles
        return random_angles(mag.shape, mag.device, generator or self._next_generator())

    # ------------------------------------------------------------------ pghi
    def pghi(
        self,
        mag: torch.Tensor,
        tolerance: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Peak-anchored PGHI phases of ``mag (..., T, F)`` (offline: central
        time stencil, no carried state).  On a CUDA tensor the recurrence runs
        inside one kernel (or raises) where ``hop | n_fft`` with overlap >= 2
        (``pghi_kernel.pghi_dispatch``); elsewhere ``pghi_scan`` serves."""
        from ..ops.cuda.pghi_kernel import pghi_dispatch

        angles = self._angles(mag, generator, angles)
        if mag.is_cuda and pghi_dispatch("phases", self.n_fft, self.hop_length) == "phases":
            from ..ops.cuda.pghi_kernel import pghi_phases_fused

            return pghi_phases_fused(
                mag, self.gamma, self.n_fft, self.hop_length,
                tolerance=self._tol(tolerance), angles=angles,
            )
        return pghi_scan(
            mag, self.gamma, self.n_fft, self.hop_length, tolerance=self._tol(tolerance),
            time_stencil="central", angles=angles,
        )

    def pghi_exact(self, mag: torch.Tensor, tolerance: Optional[float] = None) -> torch.Tensor:
        """Heap-ordered PGHI on the host, one spectrogram at a time (the oracle)."""
        m = mag.detach().cpu().numpy()
        flat = m.reshape((-1,) + m.shape[-2:])
        out = np.stack([
            pghi_heap_numpy(f, self.gamma, self.n_fft, self.hop_length, self._tol(tolerance))
            for f in flat
        ])
        return torch.as_tensor(out.reshape(m.shape), dtype=torch.float32, device=mag.device)

    # --------------------------------------------------- phase side-channel
    def _stash_phase(self, spec: torch.Tensor) -> None:
        """``keep_input`` support: remember the phase of the last forward."""
        self._phase_buffer = torch.angle(spec.detach())

    def _recall_phase(self, mag: torch.Tensor) -> Optional[torch.Tensor]:
        buf = self._phase_buffer
        if buf is None or buf.shape != mag.shape or buf.device != mag.device:
            return None
        return buf

    def griffin_lim(
        self,
        mag: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        init_phase: Optional[torch.Tensor] = None,
        fused: Optional[bool] = None,
    ) -> torch.Tensor:
        """Momentum Griffin-Lim (defaults: 30 iterations, momentum 0.99;
        configurable via ``gl_iterations`` / ``gl_momentum``)."""
        if generator is None and init_phase is None:
            generator = self._next_generator()
        return griffin_lim(
            mag,
            self.n_fft,
            self.hop_length,
            self.inv_window,
            n_iter=self.gl_iterations,
            momentum=self.gl_momentum,
            generator=generator,
            impl=self.impl,
            init_phase=init_phase,
            taps=self._inv_window_taps,
            fused=fused,
        )

    # ------------------------------------------------------------- test hooks
    def test_inversion(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The complex inversion and each ported phaseless mode."""
        spec = self.forward(x)
        outs = {"direct": self.invert(spec)}
        for mode in self.get_inversion_modes():
            if mode not in _UNPORTED_MODES:
                outs[mode] = self.invert(spec.abs(), inversion_mode=mode)
        return outs

    def realtime(self) -> "RealtimeSTFT":
        mode = (
            self.inversion_mode
            if self.inversion_mode in RealtimeSTFT.get_inversion_modes()
            else "random"
        )
        return RealtimeSTFT(
            sr=self.sr, n_fft=self.n_fft, hop_length=self.hop_length, inversion_mode=mode,
            window=self.window_name, impl=self.impl, device=self.device,
        )

    def extra_repr(self) -> str:
        return "n_fft=%d, hop_length=%d, inversion_mode=%s" % (
            self.n_fft, self.hop_length, self.inversion_mode,
        )


class RealtimeSTFT(STFT):
    """Per-frame streaming STFT.

    ``forward`` maps already-framed chunks ``(..., n_fft)`` or ``(..., T,
    n_fft)`` to spectra, ``rfft(x * window)``; inversion multiplies inverse
    frames by ``inv_window``, ``overlap`` times the canonical dual window, so
    behind an ``OverlapAdd`` the chain reconstructs at unity gain.

    Streaming state is explicit (``init_state`` / ``invert_stream``, alias
    ``step_invert``) and mode-minimal: the complex, ``keep_input`` and
    ``random`` inversions carry nothing, so their state is an empty dict;
    ``pghi`` carries the RT-PGHI frame history (``mag_buffer (..., 2, F)``,
    ``phase_buffer (..., F)``), ``pghi_gl`` that and the pinned context
    (``gl_mag`` / ``gl_phase (..., gl_context, F)``, with lookahead the pending
    magnitudes ``la_mag (..., lookahead_frames, F)``).  The eager ``invert``
    keeps the state on ``self``, and its ``keep_input`` / ``random`` calls
    keep the PGHI history too, so a later eager switch to ``pghi`` starts from
    real context.  ``gl_iterations`` (16), ``gl_context`` (``overlap - 1``)
    and ``lookahead_frames`` (0) are the streaming ``pghi_gl`` polish's
    settings; ``batch_size`` is kept for the reference's interface.
    """

    def __init__(
        self,
        sr: int = 44100,
        n_fft: int = 1024,
        hop_length: int = 256,
        inversion_mode: str = "random",
        window: str = "hann",
        impl: str = "auto",
        seed: int = 0,
        batch_size: int = 2,
        gl_iterations: int = 16,
        gl_context: Optional[int] = None,
        lookahead_frames: int = 0,
        device=None,
    ):
        super().__init__(
            sr=sr, n_fft=n_fft, hop_length=hop_length, inversion_mode=inversion_mode,
            window=window, impl=impl, seed=seed, gl_iterations=gl_iterations, device=device,
        )
        self.batch_size = int(batch_size)
        #: committed frames pinned during the streaming pghi_gl polish
        self.gl_context = (
            int(gl_context) if gl_context is not None
            else max(self.n_fft // self.hop_length - 1, 1)
        )
        #: frames the streaming pghi_gl commit is delayed by
        self.lookahead_frames = int(lookahead_frames)
        self._state: Optional[Dict[str, torch.Tensor]] = None

    def _get_inv_window(self) -> torch.Tensor:
        overlap = max(self.n_fft // self.hop_length, 1)
        return float(overlap) * dual_window(self._get_window(), self.hop_length, device=self.device)

    def propagate_mask(self, mask, x):
        """Input is already framed (..., T, n_fft): a per-frame mask (..., T)
        broadcasts to the spectra; anything else is not representable."""
        if mask is None:
            return None
        if mask.shape[-1] == x.shape[-2]:
            return mask[..., :, None]
        return None

    @staticmethod
    def get_inversion_modes() -> List[str]:
        return ["keep_input", "random", "sinebank", "pghi", "pghi_gl"]

    def _refuse_unported(self, mode: Optional[str]) -> None:
        if mode in _UNPORTED_STREAM_MODES:
            raise NotImplementedError(
                "streaming inversion mode %r of %s is not ported yet (ROADMAP %s)"
                % (mode, type(self).__name__, _UNPORTED_STREAM_MODES[mode])
            )

    # ------------------------------------------------------------- streaming
    def init_state(self, batch_shape: Tuple[int, ...] = (), mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Fresh streaming-inversion state: mode-minimal, so the complex,
        ``keep_input`` and ``random`` inversions get an empty dict,
        ``pghi`` / ``pghi_exact`` the RT-PGHI frame history (2 magnitude
        frames, 1 phase frame, zeros) and ``pghi_gl`` that history, the
        ``gl_context`` pinned frames' magnitudes and phases and, with
        lookahead, the ``lookahead_frames`` pending magnitudes.  ``mode=None``
        resolves to the configured ``inversion_mode``; the modes whose carry
        belongs to a later slice raise."""
        mode = self._resolve_mode(mode)
        self._refuse_unported(mode)
        if mode not in _PGHI_STREAM_MODES:
            return {}
        bs = tuple(batch_shape)

        def zeros(rows=None):
            return torch.zeros(bs + (() if rows is None else (rows,)) + (self.n_bins,), device=self.device)

        state = {"mag_buffer": zeros(2), "phase_buffer": zeros()}
        if mode == "pghi_gl":
            state["gl_mag"] = zeros(self.gl_context)
            state["gl_phase"] = zeros(self.gl_context)
            if self.lookahead_frames:
                state["la_mag"] = zeros(self.lookahead_frames)
        return state

    def reset(self, batch_shape: Tuple[int, ...] = (), mode: Optional[str] = None) -> None:
        self._state = self.init_state(tuple(batch_shape), mode=mode)

    def get_batch_size(self) -> int:
        return self.batch_size

    def set_batch_size(self, batch_size: int) -> None:
        self.batch_size = int(batch_size)

    # --------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(..., n_fft) -> complex (..., n_fft // 2 + 1)`` (frames already cut)."""
        self._check(x)
        spec = rfft_frames(x * self.window, impl=self.impl)
        self._stash_phase(spec)
        return spec

    def forward_with_time(self, x, time):
        """Per-frame times of framed chunks: a ``time`` that carries one value
        per frame passes through; chunk start times get the offline STFT's
        frame shifts added."""
        spec = self.forward(x)
        if x.ndim >= 2:
            T = x.shape[-2]
            if time.ndim == 0 or time.shape[-1] != T:
                shifts = torch.arange(T, device=spec.device, dtype=torch.float32) * (
                    self.hop_length / self.sr
                )
                time = shifts + (time[..., None] if time.ndim else time)
        return spec, time

    # ---------------------------------------------------------------- invert
    def invert(
        self,
        x: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        phase: Optional[torch.Tensor] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        self._check(x)
        if not x.is_complex():
            return self.invert_without_phase(x, inversion_mode, generator=generator, phase=phase,
                                             angles=angles)
        return irfft_frames(x, n_fft=self.n_fft, impl=self.impl) * self.inv_window

    def invert_without_phase(
        self,
        mag: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        phase: Optional[torch.Tensor] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Frames ``(..., T, n_fft)`` from magnitudes ``(..., T, F)``:
        ``keep_input`` takes ``phase`` or the last forward's, ``random``
        draws from ``generator`` (none: one derived from ``seed``), ``pghi``
        / ``pghi_exact`` / ``pghi_gl`` run one streaming step from the state
        kept on ``self`` (``angles`` pins the RT-PGHI seed's silent bins'
        phases)."""
        mode = self._resolve_mode(inversion_mode)
        self._refuse_unported(mode)
        if mode in _PGHI_STREAM_MODES:
            mode = "pghi_gl" if mode == "pghi_gl" else "pghi"
            state = self._eager_state(mag, mode=mode)
            self._state, y = self.invert_stream(state, mag, mode, generator=generator, angles=angles)
            return y
        if mode == "keep_input":
            phase = self._recall_phase(mag) if phase is None else phase
            if phase is None:
                phase = self._angles(mag, generator, None)
        elif mode == "random":
            phase = self._angles(mag, generator, None)
        else:
            raise ValueError("inversion mode %s not valid." % mode)
        spec = torch.polar(mag, phase.to(mag.dtype))
        # eager keep_input / random sessions keep the PGHI frame history, so
        # that a later eager switch to pghi sees real context
        self._state = self._update_buffers(self._eager_state(mag, mode="pghi"), spec)
        return self.invert(spec)

    def invert_stream(
        self,
        state: Dict[str, torch.Tensor],
        x: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Pure streaming inversion step: ``(state, spec_or_mag (..., T, F))
        -> (state, frames (..., T, n_fft))``.  ``pghi`` / ``pghi_exact`` run
        :meth:`pghi_stream` (``angles`` pins the silent bins' phases) and
        carry the history of the spectrum they build; ``pghi_gl`` runs
        :meth:`pghi_gl_stream`."""
        if x.is_complex():
            return self._update_buffers(state, x), self.invert(x)
        mode = self._resolve_mode(inversion_mode)
        self._refuse_unported(mode)
        if mode == "pghi_gl":
            return self.pghi_gl_stream(state, x, generator=generator, angles=angles)
        if mode in _PGHI_STREAM_MODES:
            spec = torch.polar(x, self.pghi_stream(state, x, generator=generator, angles=angles))
            return self._update_buffers(state, spec), self.invert(spec)
        return state, self.invert(x, inversion_mode=mode, generator=generator)

    step_invert = invert_stream

    def pghi_stream(
        self,
        state: Dict[str, torch.Tensor],
        mag: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Causal PGHI phases of one chunk ``(..., T, F)``, seeded by the
        carried frame history (backward time stencil, the chunk's own
        threshold).  Silent bins take ``angles`` or a draw from ``generator``
        (none: one derived from ``seed``)."""
        if "mag_buffer" not in state:
            raise KeyError(
                "streaming state has no PGHI history: create it with "
                "init_state(batch_shape, mode='pghi') (states are mode-minimal)"
            )
        return pghi_scan(
            mag, self.gamma, self.n_fft, self.hop_length, tolerance=self.tolerance,
            prev_mag=state["mag_buffer"], prev_phase=state["phase_buffer"],
            time_stencil="backward", angles=self._angles(mag, generator, angles),
        )

    def pghi_gl_stream(
        self,
        state: Dict[str, torch.Tensor],
        mag: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        angles: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Streaming PGHI with a Griffin-Lim polish, one chunk ``(..., T, F)``
        -> ``(state, frames (..., T, n_fft))``.

        With ``lookahead_frames = la`` the ``la`` pending magnitudes of the
        previous chunk lead this one's.  :meth:`pghi_stream` seeds the phases
        of those ``T + la`` frames (``angles``, or the draws, cover them all);
        ``gl_iterations`` windowed consistency projections then refine them
        on the grid ``[gl_context committed frames; the T + la frames]``.  The
        context rows stay pinned to their committed phases, and the last
        ``min(overlap - 1 - la, T)`` rows committed now keep the seed (their
        overlap-add lacks the right context, where the projection re-anchors
        them worse than the seed).  A projection divides the overlap-add by
        ``overlap``, not by the window envelope.  The first ``T`` frames are
        committed: the carries come from them, and the last ``la`` magnitudes
        re-enter with the next chunk."""
        if "gl_mag" not in state:
            raise KeyError(
                "streaming state has no pinned-context buffers: create it with "
                "init_state(batch_shape, mode='pghi_gl') (states are mode-minimal)"
            )
        ctx = self.gl_context
        la = self.lookahead_frames
        T_out = mag.shape[-2]
        if la:
            mag = torch.cat([state["la_mag"], mag], dim=-2)
        ph0 = self.pghi_stream(state, mag, generator=generator, angles=angles)
        mag_ext = torch.cat([state["gl_mag"], mag], dim=-2)
        ph_ext = torch.cat([state["gl_phase"], ph0], dim=-2)
        keep = self.gl_keep_rows(mag_ext.shape[-2], T_out, mag.device)[:, None]
        phase = ph_ext
        for _ in range(self.gl_iterations):
            phase = torch.where(keep, ph_ext, self._gl_project(mag_ext, phase))
        ph = phase[..., ctx:, :]
        commit_mag, commit_ph = mag[..., :T_out, :], ph[..., :T_out, :]
        spec = torch.polar(commit_mag, commit_ph)
        new_state = self._update_buffers(state, spec)
        if la:
            new_state["la_mag"] = mag[..., T_out:, :]
        new_state["gl_mag"] = torch.cat([state["gl_mag"], commit_mag], dim=-2)[..., -ctx:, :]
        new_state["gl_phase"] = torch.cat([state["gl_phase"], commit_ph], dim=-2)[..., -ctx:, :]
        return new_state, self.invert(spec)

    def gl_frozen(self, T_out: int) -> Tuple[int, int]:
        """The grid rows ``[lo, hi)`` of a ``pghi_gl`` chunk of ``T_out``
        committed frames that keep the seed (the boundary freeze): the last
        ``min(overlap - 1 - lookahead_frames, T_out)`` committed rows, counted
        from the grid's first (pinned) row."""
        overlap = max(self.n_fft // self.hop_length, 1)
        freeze_n = max(0, min(overlap - 1 - self.lookahead_frames, T_out))
        hi = self.gl_context + T_out
        return hi - freeze_n, hi

    def gl_keep_rows(self, n_rows: int, T_out: int, device=None) -> torch.Tensor:
        """The rows of a ``pghi_gl`` grid of ``n_rows`` frames that the polish
        leaves alone, ``(n_rows,)`` bool: the ``gl_context`` pinned rows and
        the frozen rows of :meth:`gl_frozen`."""
        lo, hi = self.gl_frozen(T_out)
        idx = torch.arange(n_rows, device=device)
        return (idx < self.gl_context) | ((idx >= lo) & (idx < hi))

    def _gl_project(self, mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """One windowed consistency projection of the grid ``(..., Tx, F)``:
        the phases of ``STFT(OLA(iSTFT(mag e^{i phase})) / overlap)`` re-framed
        at the grid's own frames (no trim, no reflection)."""
        overlap = max(self.n_fft // self.hop_length, 1)
        frames = irfft_frames(torch.polar(mag, phase), n_fft=self.n_fft, impl=self.impl) * self.inv_window
        y = overlap_add(frames, self.hop_length) / overlap
        fr = frame(y, self.n_fft, self.hop_length, -1)[..., : mag.shape[-2], :]
        return torch.angle(rfft_frames(fr * self.window, impl=self.impl))

    def _update_buffers(self, state: Dict[str, torch.Tensor], spec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Carry the trailing 2 magnitude frames and the last phase frame
        (wrapped: the angle of the spectrum); a no-op for states without PGHI
        history (the complex, ``keep_input`` and ``random`` sessions)."""
        if "mag_buffer" not in state:
            return state
        new = dict(state)
        mag = spec.abs()
        if spec.shape[-2] >= 2:
            new["mag_buffer"] = mag[..., -2:, :]
        else:
            new["mag_buffer"] = torch.cat([state["mag_buffer"][..., 1:, :], mag[..., -1:, :]], dim=-2)
        new["phase_buffer"] = torch.angle(spec[..., -1, :])
        return new

    def _eager_state(self, mag: torch.Tensor, mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """The stored eager state reconciled with ``mode``'s: missing or
        batch-mismatched entries are fresh, matching ones survive."""
        template = self.init_state(tuple(mag.shape[:-2]), mode=mode)
        st = self._state
        if st is None:
            return template
        out = dict(st)
        for k, v in template.items():
            prev = st.get(k)
            out[k] = prev if prev is not None and prev.shape == v.shape else v
        return out

    def realtime(self) -> "RealtimeSTFT":
        return self

    # ------------------------------------------------------------- test hooks
    def test_forward(self, x: torch.Tensor, time=None):
        """Frame the signal and run the per-frame forward."""
        out = self.forward(frame(x, self.n_fft, self.hop_length, -1))
        return out if time is None else (out, time)

    def test_inversion(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The canonical streaming loop (OverlapAdd -> forward -> invert ->
        OverlapAdd.invert over chunks of ``4 n_fft``) for the complex
        spectrum and each ported phaseless mode."""
        from .oadd import OverlapAdd

        chunk = 4 * self.n_fft
        outs = {}
        ported = [m for m in self.get_inversion_modes() if m not in _UNPORTED_STREAM_MODES]
        for mode in [None] + ported:
            oadd = OverlapAdd(self.n_fft, self.hop_length, sr=self.sr, device=self.device)
            self.reset(x.shape[:-1], mode=mode or "random")
            pieces = []
            for i in range(x.shape[-1] // chunk):
                spec = self.forward(oadd.forward(x[..., i * chunk: (i + 1) * chunk]))
                y = self.invert(spec) if mode is None else self.invert(spec.abs(), inversion_mode=mode)
                pieces.append(oadd.invert(y))
            outs["direct" if mode is None else mode] = torch.cat(pieces, -1)
        return outs
