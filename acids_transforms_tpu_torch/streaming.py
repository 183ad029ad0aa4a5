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

* ``backend="auto"`` takes a session kernel on a CUDA tensor where the chain
  and shape are covered and the session sits inside the port's measured
  region (``regions.py``: the batch cap of its mode, and for the phaseless
  sessions the ``(B, T, F)`` float32 angle buffer under ``angle_cap_bytes``),
  and the generic chunk scan otherwise and on a CPU tensor (as the JAX
  package's ``auto`` does off the TPU).  A ``sinebank`` session takes its
  closed form (torch ops, no kernel) on either device while its ``(B, T,
  n_fft)`` frame tensor stays under ``sinebank_cap_bytes``.  A chain that
  neither the JAX package's overlap-add layouts nor the session's kernels
  cover (for one, hop 250) runs the generic scan, as it does in the JAX
  package.
* ``backend="fused"`` takes the session on either device at any size (on the
  CPU its kernel wrapper runs the plain PyTorch version, like the JAX
  package's interpret mode) and raises ``ValueError`` when no session covers
  the call.
* ``backend="generic"`` forces the chunk scan.

Random modes take one ``torch.Generator`` (``generator=``) where the JAX
package takes a key; None means one seeded with 0 for the session.  The
generic scan hands it to ``chain.init_state`` (the sinebank's phases) and to
``chain.step_invert`` chunk by chunk, and the session kernels and the closed
form draw from it in the same order and shapes, so on one device both routes
see the same angles.

``mesh=`` (a ``DeviceMesh``, ``parallel/mesh.py``) runs the sessions of each
rank's slice of the leading batch axis ``shard_axis`` through the
single-device dispatch (session kernels included) under
``parallel.shard_map_batch``, with no collective; outputs and states come back
as ``DTensor`` s sharded on the batch axis.  The random modes give each shard
a generator of its own (``parallel.sharding.shard_generator``: one draw of
``generator`` with the shard index folded in), so a sharded session draws
other angles than one device would, from the same distribution.
"""
from __future__ import annotations

import copy
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .ops.framing import overlap_add
from .regions import angle_cap_bytes, batch_cap, sinebank_cap_bytes
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


def _batch_elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _cap_ok(mode: str, batch_elems: int) -> bool:
    cap = batch_cap(mode)
    return cap is None or batch_elems <= cap


def _angles_fit(rt, batch_elems: int, n_frames: int) -> bool:
    """The phaseless sessions draw their whole ``(B, T, F)`` float32 angle
    buffer up front (``ops/cuda/stream_step.py:session_angles``)."""
    return batch_elems * n_frames * rt.n_bins * 4 <= angle_cap_bytes()


def _sinebank_fits(sub2, mag_shape, chunk_frames: int) -> bool:
    """The closed form holds the session's ``(B, T, n_fft)`` float32 frames
    (and ``(B, T, F)`` angles, sines and cosines beside them)."""
    T = -(-mag_shape[-2] // chunk_frames) * chunk_frames
    return _batch_elems(mag_shape[:-2]) * T * sub2.transforms[1].n_fft * 4 <= sinebank_cap_bytes()


def _decide(plan: Optional[str], backend: str, device, inside: bool) -> str:
    """The shared rule: ``plan`` is the session that covers the call (None:
    none does), ``inside`` whether the call lies in its measured region."""
    if backend == "generic" or plan is None:
        return "generic"
    if backend == "fused":
        return plan
    if plan != "sinebank" and not _on_card(device):
        return "generic"
    return plan if inside else "generic"


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
    return _decide("fused" if available else None, backend, device,
                   _cap_ok("encode", _batch_elems(x_shape[:-1])))


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
    ``"pghi"``, ``"pghi_gl"`` or ``"complex"`` (decode session kernels),
    ``"sinebank"`` (the closed form) or ``"generic"`` (see
    :func:`plan_forward`)."""
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
    return _decide(plan, backend, device, plan is not None and _inside(plan, chain, y_shape[:-2], y_shape, chunk_frames))


def _inside(plan: str, chain, batch_shape, mag_shape, chunk_frames: int, complex_mode: str = "complex_decode") -> bool:
    """Whether a covered session lies inside its measured region: the batch
    cap of its mode, the angle buffer of the phaseless sessions, the frame
    tensor of the sinebank's closed form.  ``mag_shape`` is the session's
    ``(..., T, F)`` (T before the last chunk's padding)."""
    sub2 = _session_parts(chain)[0]
    if plan == "sinebank":
        return _sinebank_fits(sub2, mag_shape, chunk_frames)
    batch = _batch_elems(batch_shape)
    if plan == "complex":
        return _cap_ok(complex_mode, batch)
    n_frames = -(-mag_shape[-2] // chunk_frames) * chunk_frames
    return _angles_fit(sub2.transforms[1], batch, n_frames) and _cap_ok(plan, batch)


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
    ``"random"``, ``"pghi"`` or ``"pghi_gl"`` (session kernels),
    ``"sinebank"`` (the encode, then the closed form) or ``"generic"`` (see
    :func:`plan_forward`)."""
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
    inside = False
    if plan is not None:
        T_c = max(chunk_size // sub2.transforms[1].hop_length, 1)
        mag_shape = tuple(x_shape[:-1]) + (-(-x_shape[-1] // chunk_size) * T_c, sub2.transforms[1].n_bins)
        inside = _inside(plan, chain, x_shape[:-1], mag_shape, T_c, complex_mode="complex")
    return _decide(plan, backend, device, inside)


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


def _sinebank_clock(n: int, d: float) -> np.ndarray:
    """The ``time_index`` of chunks ``0 .. n-1``, ``(n,)`` float32: ``t_{i+1} =
    t_i + d`` rounded to float32 at each step, as the chunk scan advances it."""
    t = np.zeros(n, np.float32)
    for i in range(1, n):
        t[i] = t[i - 1] + np.float32(d)
    return t


def _sinebank_session(sub2, mag: torch.Tensor, chunk_frames: int,
                      generator: torch.Generator) -> torch.Tensor:
    """The whole sinebank decode in closed form, no chunk loop.

    The sinebank's carry is a deterministic ``time_index`` (``t_{i+1} = t_i +
    T_c hop / sr``) and one ``random_phase`` draw, so every frame's oscillator
    phases are known up front: ``RealtimeSTFT.sinebank_frames`` (the two
    angle-addition products of its stream step) runs once at session size
    from every chunk's start time, then one
    overlap-add (every output sample sums the frames the chunked ring
    recombination of ``OverlapAdd.step_invert`` sums).  ``time_index`` is
    accumulated in float32 chunk by chunk, as the chunk scan does (a direct
    ``i d`` product would detune long sessions), and ``random_phase`` is the
    same draw from ``generator``, in the same order, as the scan's
    ``init_state``: on one device both routes build the same angles."""
    ola_t, rt = sub2.transforms[0], sub2.transforms[1]
    T = mag.shape[-2]
    n = -(-T // chunk_frames)
    pad = n * chunk_frames - T
    if pad:
        mag = torch.nn.functional.pad(mag, (0, 0, 0, pad))
    rp = sub2.init_state(tuple(mag.shape[:-2]), mode="sinebank", generator=generator)[1]["random_phase"]
    starts = torch.as_tensor(_sinebank_clock(n, chunk_frames * rt.hop_length / rt.sr), device=mag.device)
    frames = rt.sinebank_frames(mag, starts, rp)
    y = overlap_add(frames * rt.inv_window, rt.hop_length)
    return y[..., : T * rt.hop_length] / ola_t.gain_compensation


def _session_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


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
    shard_axis: str = "data",
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
    :func:`session_frame_times` (session start at 0).  Under ``mesh=`` the
    state, when given, is batch-leading like ``x`` and the times replicated."""
    from .ops.cuda.stream_step import make_fused_forward_session

    n_chunks = -(-x.shape[-1] // chunk_size)
    if mesh is not None:
        from .parallel.sharding import shard_map_batch

        def inner(v, *st):
            return scan_forward(chain, v, chunk_size, st[0] if st else None, backend)

        ys, st = shard_map_batch(inner, mesh, shard_axis)(*((x,) if state is None else (x, state)))
        return (ys, session_frame_times(chain, chunk_size, n_chunks), st) if with_time else (ys, st)
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
    shard_axis: str = "data",
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
    recurrence and the projections, then P's synthesis.  ``"sinebank"``
    takes a closed form on either device (:func:`_sinebank_session`).
    Under ``mesh=`` the spectra need an explicit batch axis ``(B, T, F)``."""
    from .ops.cuda.stream_step import (
        make_fused_complex_invert,
        make_fused_pghi_gl_invert,
        make_fused_pghi_invert,
        make_fused_random_invert,
    )

    if mesh is not None:
        from .parallel.sharding import shard_map_batch

        if getattr(y, "ndim", 0) < 3:
            # the generic rank-2 guard would take an unbatched (T, F)
            # spectrogram's frame axis for a batch axis
            raise ValueError(
                "scan_invert(mesh=): spectra must carry an explicit leading batch axis "
                "(B, T, F); got shape %r.  Add a batch dim (y[None]) or drop mesh=."
                % (tuple(getattr(y, "shape", ())),)
            )

        def inner(v, g):
            return scan_invert(chain, v, chunk_frames, inversion_mode, g, backend)

        return shard_map_batch(inner, mesh, shard_axis, keyed=True)(y, generator)
    plan = plan_invert(chain, tuple(y.shape), chunk_frames, inversion_mode,
                       y_is_complex=y.is_complex(), backend=backend, device=y.device)
    g = _session_generator(generator, y.device)
    if plan == "sinebank":
        sub2, mag_t = _session_parts(chain)
        return _sinebank_session(sub2, mag_t.invert(y) if mag_t is not None else y, chunk_frames, g)
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
    state = chain.init_state(tuple(y.shape[:-2]), mode=inversion_mode, generator=g)
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
    shard_axis: str = "data",
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
    (``"pghi_gl"``).  ``"sinebank"`` encodes with :func:`scan_forward` (R on
    the card), takes the magnitudes (through the Magnitude's forward and
    invert on a 3-chain) and decodes by the closed form."""
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

    if mesh is not None:
        from .parallel.sharding import shard_map_batch

        def inner(v, g):
            return scan_roundtrip(chain, v, chunk_size, inversion_mode, g, backend)

        return shard_map_batch(inner, mesh, shard_axis, keyed=True)(x, generator)
    plan = plan_roundtrip(chain, tuple(x.shape), chunk_size, inversion_mode, backend=backend,
                          device=x.device)
    g = _session_generator(generator, x.device)
    if plan == "sinebank":
        sub2, mag_t = _session_parts(chain)
        spec, _ = scan_forward(sub2, x, chunk_size)
        mags = mag_t.invert(mag_t.forward(spec)) if mag_t is not None else spec.abs()
        return _sinebank_session(sub2, mags, chunk_size // sub2.transforms[1].hop_length, g)
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
    state = chain.init_state(tuple(x.shape[:-1]), mode=inversion_mode, generator=g)
    recs = []
    for chunk in chunk_signal(x, chunk_size):
        state, y = chain.step(state, chunk)
        if inversion_mode is not None and y.is_complex():
            y = y.abs()  # phaseless roundtrip (the reference's test loop)
        state, rec = chain.step_invert(state, y, inversion_mode=inversion_mode, generator=g)
        recs.append(rec)
    return torch.cat(recs, dim=-1)
