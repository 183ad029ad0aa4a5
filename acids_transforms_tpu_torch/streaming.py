"""Chunked processing of streaming transform chains (twin of the JAX
``streaming.py``).

The chain's state is explicit (``chain.init_state``) and a session is a loop
over chunks of ``chain.step`` / ``chain.step_invert`` (a Python loop where the
JAX package has ``lax.scan``).  Recognized ``[OverlapAdd, RealtimeSTFT(,
Magnitude)]`` chains run whole sessions in one to three kernel launches
instead, and ``pghi_gl`` sessions in a few launches a chunk over all sessions
at once (``ops/cuda/stream_step.py``)::

    chain = OverlapAdd(1024, 256) + RealtimeSTFT(n_fft=1024, hop_length=256)
    y = scan_roundtrip(chain, x, chunk_size=4096)        # analysis + resynthesis
    frames, state = scan_forward(chain, x, 4096)          # analysis only

Dispatch (``plan_forward`` / ``plan_invert`` / ``plan_roundtrip`` make the
decision, the scans execute it):

* ``backend="auto"`` takes a session kernel on a CUDA tensor whenever the
  chain and shape are covered, and the generic chunk scan on a CPU tensor
  (as the JAX package's ``auto`` does off the TPU).  A covered call whose
  kernel is not ported yet (``sinebank``) raises ``NotImplementedError`` on a
  CUDA tensor naming its ROADMAP item; a chain that neither the JAX
  package's overlap-add layouts nor the session's kernels cover (for one,
  hop 250) runs the generic scan, as it does in the JAX package.
* ``backend="fused"`` takes the session on either device (on the CPU its
  kernel wrapper runs the plain PyTorch version, like the JAX package's
  interpret mode) and raises ``ValueError`` when no session covers the call.
* ``backend="generic"`` forces the chunk scan.

The TPU's batch caps and angle-buffer footprint gates
(``dispatch_regions.json``) are TPU crossovers and are not carried over; the
port's own table waits for ``regions.py`` (ROADMAP Queue 1 item 9b(iii)).

Random modes take one ``torch.Generator`` (``generator=``) where the JAX
package takes a key; None means one seeded with 0 for the session.  The
generic scan hands it to ``chain.step_invert`` chunk by chunk and the session
kernels draw their angles from it in the same order and shapes, so on one
device both routes see the same angles.  ``mesh=`` (multi-device sessions)
raises ``NotImplementedError`` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import copy
from typing import Any, Optional, Tuple

import torch

from .transforms.base import AudioTransform

__all__ = [
    "chunk_signal",
    "plan_forward",
    "plan_invert",
    "plan_roundtrip",
    "scan_forward",
    "scan_invert",
    "scan_roundtrip",
    "session_frame_times",
]

#: sessions whose kernel comes with a later slice
_UNPORTED_PLANS = {
    "sinebank": "Queue 1 item 9b(ii) (sinebank_stream, _sinebank_session)",
}


def _session_parts(chain):
    """Recognize ``[OverlapAdd, RealtimeSTFT]`` and ``[OverlapAdd,
    RealtimeSTFT, Magnitude]`` session chains: ``(two_chain, mag_t)``, the
    framing + spectral two-chain the session kernels cover and the
    (stateless, frame-local) Magnitude applied to the whole session around
    them, or None."""
    from .transforms.base import ComposeAudioTransform
    from .transforms.oadd import OverlapAdd
    from .transforms.spectral_repr import Magnitude
    from .transforms.stft import RealtimeSTFT

    if not isinstance(chain, ComposeAudioTransform):
        return None
    ts = list(chain.transforms)
    if len(ts) == 2 and isinstance(ts[0], OverlapAdd) and isinstance(ts[1], RealtimeSTFT):
        return chain, None
    if (
        len(ts) == 3
        and isinstance(ts[0], OverlapAdd)
        and isinstance(ts[1], RealtimeSTFT)
        and type(ts[2]) is Magnitude
    ):
        return ts[0] + ts[1], ts[2]
    return None


def _on_card(device) -> bool:
    return torch.device("cuda" if device is None else device).type == "cuda"


def _check_backend(name: str, backend: str) -> None:
    if backend not in ("auto", "fused", "generic"):
        raise ValueError(
            "unknown %s backend %r (use 'auto', 'fused' or 'generic')" % (name, backend)
        )


def _decide(plan: Optional[str], backend: str, device) -> str:
    """The shared rule: ``plan`` is the session that covers the call (None:
    none does)."""
    if backend == "generic" or plan is None:
        return "generic"
    if backend == "auto" and not _on_card(device):
        return "generic"
    if plan in _UNPORTED_PLANS:
        raise NotImplementedError(
            "the %r streaming session is not ported yet (ROADMAP %s); use "
            "backend='generic'" % (plan, _UNPORTED_PLANS[plan])
        )
    return plan


def plan_forward(
    chain: AudioTransform,
    x_shape: Tuple[int, ...],
    chunk_size: int,
    has_state: bool = False,
    backend: str = "auto",
    device=None,
) -> str:
    """The :func:`scan_forward` dispatch decision, as data: ``"fused"`` (the
    whole-session encode kernel) or ``"generic"`` (the chunk scan), for an
    input of ``x_shape`` on ``device`` (None: the card).  Raises as the scan
    does: unknown ``backend``, and ``backend="fused"`` with no covering
    session."""
    from .ops.cuda.stream_step import fused_forward_session_available

    _check_backend("scan_forward", backend)
    parts = _session_parts(chain)
    available = (
        not has_state and parts is not None
        and fused_forward_session_available(parts[0], chunk_size)
    )
    if backend == "fused" and not available:
        raise ValueError(
            "backend='fused' requested but the fused encode-session kernel "
            "cannot cover this call (needs a fresh-state "
            "[OverlapAdd, RealtimeSTFT(, Magnitude)] chain with a "
            "layout the session kernels cover); use backend='auto' to fall back to "
            "the generic scan"
        )
    return _decide("fused" if available else None, backend, device)


def plan_invert(
    chain: AudioTransform,
    y_shape: Tuple[int, ...],
    chunk_frames: int,
    inversion_mode: Optional[str] = None,
    y_is_complex: bool = False,
    backend: str = "auto",
    device=None,
) -> str:
    """The :func:`scan_invert` dispatch decision, as data: ``"random"``,
    ``"pghi"``, ``"pghi_gl"`` or ``"complex"`` (decode session kernels) or
    ``"generic"``; a covered ``"sinebank"`` session raises
    ``NotImplementedError`` until its slice (see :func:`plan_forward`)."""
    from .ops.cuda import stream_step as ss

    _check_backend("scan_invert", backend)
    parts = _session_parts(chain)
    plan = None
    if parts is not None:
        sub2, mag_t = parts
        gates = {"random": ss.fused_random_invert_available, "pghi": ss.fused_pghi_invert_available,
                 "pghi_gl": ss.fused_pghi_gl_invert_available}
        if inversion_mode in gates and gates[inversion_mode](sub2, chunk_frames):
            plan = inversion_mode
        elif (inversion_mode is None and y_is_complex and mag_t is None
              and ss.fused_complex_invert_available(sub2, chunk_frames)):
            plan = "complex"
        elif inversion_mode == "sinebank" and _same_framing(sub2):
            plan = "sinebank"
    if backend == "fused" and plan is None:
        raise ValueError(
            "backend='fused' requested but no fused invert-session path "
            "covers this call (needs an [OverlapAdd, RealtimeSTFT"
            "(, Magnitude)] chain with inversion_mode 'random', 'pghi', "
            "'pghi_gl' or 'sinebank' — or a complex spectrum with mode "
            "None, 2-chain only — and a layout the session kernels cover); use "
            "backend='auto' to fall back to the generic scan"
        )
    return _decide(plan, backend, device)


def _same_framing(sub2) -> bool:
    ola_t, rt = sub2.transforms[0], sub2.transforms[1]
    return ola_t.n_fft == rt.n_fft and ola_t.hop_length == rt.hop_length


def plan_roundtrip(
    chain: AudioTransform,
    x_shape: Tuple[int, ...],
    chunk_size: int,
    inversion_mode: Optional[str] = None,
    backend: str = "auto",
    device=None,
) -> str:
    """The :func:`scan_roundtrip` dispatch decision, as data: ``"complex"``,
    ``"random"``, ``"pghi"`` or ``"pghi_gl"`` (session kernels) or
    ``"generic"``; a covered ``"sinebank"`` session raises
    ``NotImplementedError`` until its slice (see :func:`plan_forward`)."""
    from .ops.cuda import stream_step as ss

    _check_backend("scan_roundtrip", backend)
    parts = _session_parts(chain)
    plan = None
    if parts is not None:
        sub2, mag_t = parts
        if mag_t is None:
            # the two-chain's roundtrip sessions
            gates = {None: ss.fused_roundtrip_available, "random": ss.fused_random_roundtrip_available,
                     "pghi": ss.fused_pghi_roundtrip_available, "pghi_gl": ss.fused_pghi_gl_roundtrip_available}
            covered = inversion_mode in gates and gates[inversion_mode](sub2, chunk_size)
        else:
            # the 3-chain: the magnitude encode, then the decode session
            gates = {"random": ss.fused_random_invert_available, "pghi": ss.fused_pghi_invert_available,
                     "pghi_gl": ss.fused_pghi_gl_invert_available}
            covered = (inversion_mode in gates and ss.fused_forward_session_available(sub2, chunk_size)
                       and gates[inversion_mode](sub2, chunk_size // sub2.transforms[1].hop_length))
        if covered:
            plan = "complex" if inversion_mode is None else inversion_mode
        elif (inversion_mode == "sinebank" and _same_framing(sub2)
              and chunk_size % sub2.transforms[1].hop_length == 0):
            plan = "sinebank"
    if backend == "fused" and plan is None:
        raise ValueError(
            "backend='fused' requested but no fused session path covers "
            "this call (needs an [OverlapAdd, RealtimeSTFT(, Magnitude)] "
            "chain with inversion_mode None, 'random', 'sinebank', 'pghi' "
            "or 'pghi_gl' — complex roundtrips 2-chain only — chunk_size "
            "a hop multiple, a layout the kernels cover); use backend='auto' to "
            "fall back to the generic scan"
        )
    return _decide(plan, backend, device)


def chunk_signal(x: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """Split ``(..., L)`` into leading-axis chunks ``(N, ..., chunk_size)``,
    zero-padding the tail."""
    L = x.shape[-1]
    n = -(-L // chunk_size)
    pad = n * chunk_size - L
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return torch.movedim(x.reshape(x.shape[:-1] + (n, chunk_size)), -2, 0)


def session_frame_times(chain: AudioTransform, chunk_size: int, n_chunks: int) -> torch.Tensor:
    """Frame-start times (seconds) of a whole chunked session: what feeding
    chunk ``i`` with start time ``i * chunk_size / sr`` through the chain's
    ``forward_with_time`` yields, for all ``n_chunks`` at once.  The per-chunk
    pattern is probed from a copy of the chain (one zero chunk), so the
    caller's chain and its eager state stay untouched."""
    snap = copy.deepcopy(chain)
    dev = snap.device
    _, tmap = snap.forward_with_time(
        torch.zeros((chunk_size,), device=dev), torch.zeros((), device=dev)
    )
    tmap = torch.atleast_1d(tmap).to(torch.float32)
    starts = torch.arange(n_chunks, device=dev, dtype=torch.float32) * (chunk_size / float(snap.sr))
    return (tmap[None, :] + starts[:, None]).reshape(-1)


def _session_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "multi-device streaming sessions (mesh=) are not ported yet "
            "(ROADMAP Queue 1 item 12)"
        )


def _concat_frames(ys):
    """Per-chunk outputs ``(..., T_c, F...)`` concatenated along the frame axis."""
    return torch.cat(ys, dim=-2) if ys[0].ndim >= 2 else torch.cat(ys, dim=-1)


def scan_forward(
    chain: AudioTransform,
    x: torch.Tensor,
    chunk_size: int,
    state: Any = None,
    backend: str = "auto",
    mesh: Any = None,
    with_time: bool = False,
):
    """Run the chain's streaming forward over chunks of ``x``: ``(outputs,
    final_state)``, outputs concatenated along the frame axis (-2).

    A fresh (``state=None``) session of a recognized chain runs the
    whole-session encode kernel on a CUDA tensor (R): the forward is
    stateless past the framing ring, so the final state is computed in
    closed form.  ``state=`` resumes a session (the generic scan; a state
    carried over from the JAX package goes through
    ``convert.load_jax_stream_state``).  ``with_time=True`` returns
    ``(outputs, times, final_state)`` with the frame-start seconds of
    :func:`session_frame_times` (session start at 0)."""
    from .ops.cuda.stream_step import make_fused_forward_session

    _no_mesh(mesh)
    n_chunks = -(-x.shape[-1] // chunk_size)
    times = session_frame_times(chain, chunk_size, n_chunks) if with_time else None

    def _ret(ys, st):
        return (ys, times, st) if with_time else (ys, st)

    plan = plan_forward(chain, tuple(x.shape), chunk_size, has_state=state is not None,
                        backend=backend, device=x.device)
    if plan == "fused":
        sub2, mag_t = _session_parts(chain)
        spec, st2 = make_fused_forward_session(sub2, chunk_size)(x)
        if mag_t is None:
            return _ret(spec, st2)
        # Magnitude is stateless and frame-local: applied to the whole
        # session it equals the generic scan's per-chunk application
        full_state = chain.init_state(tuple(x.shape[:-1]))
        full_state[0] = st2[0]
        return _ret(mag_t.forward(spec), full_state)

    if state is None:
        state = chain.init_state(tuple(x.shape[:-1]))
    ys = []
    for chunk in chunk_signal(x, chunk_size):
        state, y = chain.step(state, chunk)
        ys.append(y)
    return _ret(_concat_frames(ys), state)


def scan_invert(
    chain: AudioTransform,
    y: torch.Tensor,
    chunk_frames: int,
    inversion_mode: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    backend: str = "auto",
    mesh: Any = None,
) -> torch.Tensor:
    """Streaming DECODE: spectra or magnitudes ``(..., T, F)`` -> audio
    ``(..., T * R)`` (``R = hop`` for ``[OverlapAdd, RealtimeSTFT]``), chunks
    of ``chunk_frames`` frames through ``chain.step_invert`` (the last chunk
    zero-frame padded, the output cut back).  ``y`` is magnitudes for the
    phaseless modes, a complex spectrum for ``None``.  On a CUDA tensor a
    recognized chain runs whole-session decode kernels: P (``"random"``),
    the RT-PGHI recurrence and P's synthesis (``"pghi"``, Q), S (a complex
    spectrum); feature chains ``[..., Magnitude]`` run ``Magnitude.invert``
    on the whole session first (stateless and frame-local: equal to the
    per-chunk application).  ``"pghi_gl"`` runs O: per chunk the seeded
    recurrence and the projections, then P's synthesis."""
    from .ops.cuda.stream_step import (
        make_fused_complex_invert,
        make_fused_pghi_gl_invert,
        make_fused_pghi_invert,
        make_fused_random_invert,
    )

    _no_mesh(mesh)
    plan = plan_invert(chain, tuple(y.shape), chunk_frames, inversion_mode,
                       y_is_complex=y.is_complex(), backend=backend, device=y.device)
    g = _session_generator(generator, y.device)
    if plan == "complex":
        return make_fused_complex_invert(_session_parts(chain)[0], chunk_frames)(y)
    if plan in ("random", "pghi", "pghi_gl"):
        sub2, mag_t = _session_parts(chain)
        ym = mag_t.invert(y) if mag_t is not None else y
        maker = {"random": make_fused_random_invert, "pghi": make_fused_pghi_invert,
                 "pghi_gl": make_fused_pghi_gl_invert}[plan]
        return maker(sub2, chunk_frames, generator=g)(ym)

    T = y.shape[-2]
    n = -(-T // chunk_frames)
    pad = n * chunk_frames - T
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
    state = chain.init_state(tuple(y.shape[:-2]), mode=inversion_mode)
    recs = []
    for i in range(n):
        state, rec = chain.step_invert(
            state, y[..., i * chunk_frames: (i + 1) * chunk_frames, :],
            inversion_mode=inversion_mode, generator=g,
        )
        recs.append(rec)
    out = torch.cat(recs, dim=-1)
    ratio = out.shape[-1] // (n * chunk_frames)
    return out[..., : T * ratio]


def scan_roundtrip(
    chain: AudioTransform,
    x: torch.Tensor,
    chunk_size: int,
    inversion_mode: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    backend: str = "auto",
    mesh: Any = None,
) -> torch.Tensor:
    """Full streaming roundtrip (forward then invert, chunk by chunk): the
    reference's realtime loop.  Returns ``(..., n_chunks * chunk_size)``,
    delayed by ``(overlap - 1) * hop`` samples.  With ``inversion_mode`` set
    the roundtrip is phaseless (the spectrum's magnitude is inverted);
    ``None`` keeps the complex spectrum.  On a CUDA tensor recognized chains
    run session kernels: L (complex), M (``"random"``), N (``"pghi"``: the
    magnitude encode, the RT-PGHI recurrence, P's synthesis), O
    (``"pghi_gl"``: the magnitude encode, then per chunk the seeded recurrence
    and the projections, then P's synthesis); a ``[..., Magnitude]`` chain
    runs the magnitude encode, the Magnitude forward and invert on the whole
    session, then P (``"random"``), Q (``"pghi"``) or O's decode
    (``"pghi_gl"``)."""
    from .ops.cuda.stream_step import (
        make_fused_magnitude_session,
        make_fused_pghi_gl_invert,
        make_fused_pghi_gl_roundtrip,
        make_fused_pghi_invert,
        make_fused_pghi_roundtrip,
        make_fused_random_invert,
        make_fused_random_roundtrip,
        make_fused_roundtrip,
    )

    _no_mesh(mesh)
    plan = plan_roundtrip(chain, tuple(x.shape), chunk_size, inversion_mode, backend=backend,
                          device=x.device)
    g = _session_generator(generator, x.device)
    if plan == "complex":
        return make_fused_roundtrip(chain, chunk_size)(x)
    if plan in ("random", "pghi", "pghi_gl"):
        sub2, mag_t = _session_parts(chain)
        if mag_t is None:
            maker = {"random": make_fused_random_roundtrip, "pghi": make_fused_pghi_roundtrip,
                     "pghi_gl": make_fused_pghi_gl_roundtrip}[plan]
            return maker(chain, chunk_size, generator=g)(x)
        T_c = chunk_size // sub2.transforms[1].hop_length
        mags = mag_t.invert(mag_t.forward(make_fused_magnitude_session(sub2, chunk_size)(x)))
        maker = {"random": make_fused_random_invert, "pghi": make_fused_pghi_invert,
                 "pghi_gl": make_fused_pghi_gl_invert}[plan]
        return maker(sub2, T_c, generator=g)(mags)

    # states are mode-minimal: each stateful child allocates the carry of
    # the session's inversion mode
    state = chain.init_state(tuple(x.shape[:-1]), mode=inversion_mode)
    recs = []
    for chunk in chunk_signal(x, chunk_size):
        state, y = chain.step(state, chunk)
        if inversion_mode is not None and y.is_complex():
            y = y.abs()  # phaseless roundtrip (the reference's test loop)
        state, rec = chain.step_invert(state, y, inversion_mode=inversion_mode, generator=g)
        recs.append(rec)
    return torch.cat(recs, dim=-1)
