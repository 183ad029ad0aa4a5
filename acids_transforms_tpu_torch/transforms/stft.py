"""STFT transform pair: offline and per-frame streaming (twin of the JAX
``transforms/stft.py``).

``STFT`` ported: forward, the complex least-squares inversion and every
phaseless mode of the JAX package: ``griffin_lim``, ``pghi``, ``pghi_bidir``,
``pghi_exact``, ``pghi_gl``, ``random``, ``keep_input`` and ``sinebank`` (the
additive resynthesis, bins in blocks so that peak memory is ``O(block * L)``);
on a CUDA tensor ``griffin_lim`` and ``pghi_gl`` run the Griffin-Lim kernels
of ``ops/cuda/glstep.py``.

``RealtimeSTFT`` ported: the per-frame forward, the dual-window synthesis and
the streaming inversion (``init_state`` / ``step_invert``) of the complex
spectrum and of the modes ``keep_input``, ``random``, ``pghi`` (causal
RT-PGHI carrying two magnitude frames and one phase frame; ``pghi_exact`` maps
to it, there is no heap online), ``pghi_gl`` (the RT-PGHI seed polished by
``gl_iterations`` windowed consistency projections with ``gl_context``
committed frames pinned, optionally ``lookahead_frames`` of delayed commit)
and ``sinebank`` (an oscillator bank carrying its ``time_index`` and its
``random_phase`` across chunks).

The PGHI modes work on any named window through its effective
time-frequency ratio (``gamma``).  On a CUDA tensor ``pghi`` / ``pghi_bidir``
launch the kernels of ``ops/cuda/pghi_kernel.py`` where they cover the
shape or the JAX package's structural gates hold (raising where a kernel's
limit bites), and run the recurrence kernel or ``pghi_scan`` with the ISTFT
elsewhere (``pghi_kernel.pghi_dispatch``), as the JAX package does on a TPU;
on a CPU tensor they run ``ops/pghi.py:pghi_scan`` and
the ISTFT (both as the causal scan: the bidirectional order exists for the
card).  ``sinebank`` is torch ops on both devices (the JAX package writes it
in XLA, not as a kernel).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import math

import numpy as np
import torch

from ..ops.fft import irfft_frames, istft, rfft_frames, stft as stft_op, taps_for_window
from ..ops.framing import frame, overlap_add
from ..ops.griffinlim import griffin_lim
from ..ops.interp import interp_linear
from ..ops.pghi import pghi_scan, random_angles
from ..ops.windows import dual_window, get_window, window_gamma
from .base import AudioTransform

__all__ = ["STFT", "RealtimeSTFT"]

#: streaming modes that carry the RT-PGHI frame history
_PGHI_STREAM_MODES = ("pghi", "pghi_exact", "pghi_gl")
_TWO_PI = 2.0 * math.pi


def linspace32(stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` in float32, bit for bit: ``i * (stop
    * (1 / (num - 1)))`` for ``i < num - 1``, each factor rounded to float32
    (XLA folds the constants of ``stop * (i / (num - 1))`` into one), and
    ``stop`` itself last.  ``torch.linspace`` fills its second half from the
    end and rounds otherwise."""
    stop32 = np.float32(stop)
    if num == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    scale = stop32 * (np.float32(1.0) / np.float32(num - 1))
    out = np.concatenate([np.arange(num - 1, dtype=np.float32) * scale, np.array([stop32], np.float32)])
    return torch.as_tensor(out, device=device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as a fused multiply-add
    rounds it: the offline sinebank's oscillator angles are built so, as XLA
    contracts the JAX package's ``a * b + c`` in its compiled loop body into
    one FMA.  The float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


class STFT(AudioTransform):
    """Offline STFT with phaseless inversion.

    Inversion modes: ``griffin_lim`` (default), ``keep_input``, ``random``,
    ``sinebank`` and the PGHI family (``pghi``, ``pghi_bidir``,
    ``pghi_exact``, ``pghi_gl``).
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
        phases and the sinebank's oscillator phases ``(F,)``; ``phase`` is
        ``keep_input``'s explicit phase."""
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
        if mode == "sinebank":
            return self.get_sinebank_inversion(mag, generator=generator, angles=angles)
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
        """Heap-ordered PGHI on the host, one spectrogram at a time, by the
        native heap (``native/pghi.cc``; its plain version and oracle is
        ``ops/pghi.py:pghi_heap_numpy``)."""
        from ..native import pghi_native

        m = mag.detach().cpu().numpy()
        flat = m.reshape((-1,) + m.shape[-2:])
        out = np.stack([
            pghi_native.pghi(f, self.gamma, self.n_fft, self.hop_length, self._tol(tolerance))
            for f in flat
        ])
        return torch.as_tensor(out.reshape(m.shape), dtype=torch.float32, device=mag.device)

    def get_sinebank_inversion(
        self,
        mag: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        angles: Optional[torch.Tensor] = None,
        bin_block: int = 64,
    ) -> torch.Tensor:
        """Additive resynthesis: each bin's envelope, linearly upsampled to
        the sample rate, modulates a sine at the bin's frequency with a random
        phase (``angles (F,)``, or a draw from ``generator``).  The magnitudes
        are divided by their largest value over the whole batch and so is the
        result; ``hop * T + n_fft`` samples come out.  Bins are summed
        ``bin_block`` at a time, so peak memory is ``O(block * L)``, not the
        ``(F, L)`` envelope tensor at once.  The oscillator angle ``2 pi f t +
        phi`` is built as the JAX package builds it, from the same float32
        grids: at 4 s and 22 kHz it reaches 5.5e5 rad, where one float32 ulp
        is 0.06 rad."""
        T, n_bins = mag.shape[-2], mag.shape[-1]
        dev = mag.device
        freqs = linspace32(self.sr / 2.0, n_bins, dev)
        phi = angles if angles is not None else random_angles(
            (n_bins,), dev, generator or self._next_generator()
        )
        phi = phi.to(device=dev, dtype=torch.float32).reshape(n_bins)
        magT = (mag / mag.abs().max()).transpose(-2, -1)  # (..., F, T)
        final_length = self.hop_length * T + self.n_fft
        t = linspace32(final_length / self.sr, final_length, dev)[None, :]
        y = mag.new_zeros(mag.shape[:-2] + (final_length,))
        for lo in range(0, n_bins, bin_block):
            hi = min(lo + bin_block, n_bins)
            env = interp_linear(magT[..., lo:hi, :], final_length).div_(_TWO_PI)
            sines = torch.sin(fma32(_TWO_PI * freqs[lo:hi, None], t, phi[lo:hi, None]))  # (block, L)
            y = y + env.mul_(sines).sum(-2)
        return y / y.abs().max()

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
        """The complex inversion and every phaseless mode."""
        spec = self.forward(x)
        outs = {"direct": self.invert(spec)}
        for mode in self.get_inversion_modes():
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
    magnitudes ``la_mag (..., lookahead_frames, F)``), ``sinebank`` its
    oscillators' ``time_index`` (a float32 scalar whatever the batch) and
    ``random_phase (..., 1, F)``.  The eager ``invert``
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

    # ------------------------------------------------------------- streaming
    def init_state(self, batch_shape: Tuple[int, ...] = (), mode: Optional[str] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Fresh streaming-inversion state: mode-minimal, so the complex,
        ``keep_input`` and ``random`` inversions get an empty dict,
        ``pghi`` / ``pghi_exact`` the RT-PGHI frame history (2 magnitude
        frames, 1 phase frame, zeros), ``pghi_gl`` that history, the
        ``gl_context`` pinned frames' magnitudes and phases and, with
        lookahead, the ``lookahead_frames`` pending magnitudes, and
        ``sinebank`` ``time_index`` (0) and ``random_phase (..., 1, F)`` drawn
        from ``generator`` (none: one derived from ``seed``).  ``mode=None``
        resolves to the configured ``inversion_mode``."""
        mode = self._resolve_mode(mode)
        bs = tuple(batch_shape)
        if mode == "sinebank":
            return {
                "time_index": torch.zeros((), device=self.device),
                "random_phase": random_angles(bs + (1, self.n_bins), self.device,
                                              generator or self._next_generator()),
            }
        if mode not in _PGHI_STREAM_MODES:
            return {}

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
        / ``pghi_exact`` / ``pghi_gl`` / ``sinebank`` run one streaming step from
        the state kept on ``self`` (``angles`` pins the RT-PGHI seed's silent
        bins' phases)."""
        mode = self._resolve_mode(inversion_mode)
        if mode == "sinebank":
            self._state, y = self.sinebank_stream(self._eager_state(mag, mode="sinebank"), mag)
            return y * self.inv_window
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
        :meth:`pghi_gl_stream`, ``sinebank`` :meth:`sinebank_stream`."""
        if x.is_complex():
            return self._update_buffers(state, x), self.invert(x)
        mode = self._resolve_mode(inversion_mode)
        if mode == "sinebank":
            state, y = self.sinebank_stream(state, x)
            return state, y * self.inv_window
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

    def sinebank_stream(self, state: Dict[str, torch.Tensor], mag: torch.Tensor
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Stateful sinebank resynthesis of one chunk: ``mag (..., T, F) ->
        (state, frames (..., T, n_fft))``, before the synthesis window.  Bin
        ``f`` of frame ``t`` is an oscillator of phase ``A = omega_f (t hop /
        sr + time_index) + random_phase_f`` over the frame's samples ``n``; by
        the angle-addition identity the ``(T, F, n_fft)`` broadcast becomes
        two ``(T, F) x (F, n_fft)`` products at the port's float32 matmul
        precision.  ``time_index`` then advances by ``T hop / sr`` in
        float32, so the sines run on across chunks.  ``A`` is rounded after
        each operation, as the JAX package's step computes it op by op."""
        if "time_index" not in state:
            raise KeyError(
                "streaming state has no sinebank continuity: create it with "
                "init_state(batch_shape, mode='sinebank') (states are mode-minimal)"
            )
        T = mag.shape[-2]
        y = self.sinebank_frames(mag, state["time_index"], state["random_phase"])
        new_state = dict(state)
        new_state["time_index"] = state["time_index"] + T * self.hop_length / self.sr
        return new_state, y

    def sinebank_frames(self, mag: torch.Tensor, starts: torch.Tensor, random_phase: torch.Tensor
                        ) -> torch.Tensor:
        """The sinebank frames ``(..., T, n_fft)`` of ``mag (..., T, F)`` cut
        into ``len(starts)`` equal chunks, chunk ``i`` starting at ``starts[i]``
        seconds (a scalar: one chunk): frame ``t`` of a chunk sits at ``t hop /
        sr`` past its start.  :meth:`sinebank_stream` runs one chunk, the
        streaming closed form a whole session."""
        T, n_bins = mag.shape[-2], mag.shape[-1]
        dev = mag.device
        starts = starts.reshape(-1, 1, 1)
        omega = _TWO_PI * linspace32(self.sr / 2.0, n_bins, dev)  # rad/s
        frame_t = torch.arange(T // starts.shape[0], dtype=torch.float32, device=dev)[:, None] * (
            self.hop_length / self.sr)
        A = omega[None, :] * (frame_t + starts).reshape(T, 1) + random_phase
        n = torch.arange(self.n_fft, dtype=torch.float32, device=dev)[None, :] / self.sr
        ang = omega[:, None] * n  # the in-frame oscillators, (F, n_fft)
        C, S = torch.cos(ang), torch.sin(ang)
        return (torch.matmul(mag * torch.sin(A), C) + torch.matmul(mag * torch.cos(A), S)) / n_bins

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
        spectrum and every phaseless mode."""
        from .oadd import OverlapAdd

        chunk = 4 * self.n_fft
        outs = {}
        for mode in [None] + self.get_inversion_modes():
            oadd = OverlapAdd(self.n_fft, self.hop_length, sr=self.sr, device=self.device)
            self.reset(x.shape[:-1], mode=mode or "random")
            pieces = []
            for i in range(x.shape[-1] // chunk):
                spec = self.forward(oadd.forward(x[..., i * chunk: (i + 1) * chunk]))
                y = self.invert(spec) if mode is None else self.invert(spec.abs(), inversion_mode=mode)
                pieces.append(oadd.invert(y))
            outs["direct" if mode is None else mode] = torch.cat(pieces, -1)
        return outs
