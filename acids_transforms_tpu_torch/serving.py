"""Serving: bucketed, shape-stable execution of transform chains (twin of
the JAX ``serving.py``).

Production audio arrives with arbitrary lengths and batch sizes.
:class:`CompiledTransform` makes the serving contract explicit:

* lengths are quantized to a bucket ladder (``utils/bucketing.py``) and
  zero-padded, batches to a batch ladder: the chain only ever sees
  ``len(buckets) x len(batch_sizes)`` input shapes per direction, all of
  which :meth:`~CompiledTransform.warmup` runs ahead of time (the kernels'
  build, the tables they read and the allocator's blocks are then in place).
  The server records the shapes it hands to the chain (``shapes``), so that
  the contract can be checked;
* ``invert`` runs through the same discipline: the frame axis of the
  features (the chain-folded ``output_frame_axis``) is padded to the
  frame-count ladder derived from the sample buckets;
* outputs are trimmed to the shape the *unbucketed* call would produce.  The
  forward's comes from the chain itself, run on the ``meta`` device (shapes
  only, no launch, no data); the invert's from the bucketed call's, less
  ``ratio`` samples per padded frame (a framing inverse lengthens its output
  by one hop per frame);
* the server executes a **snapshot** of the transform taken at construction
  (a deep copy of the module on the same device): later eager refits
  (``scale_data``) change nothing until :meth:`~CompiledTransform.refresh`.

A chain that ``fuse.fusable`` matches serves through ``fuse.fuse_forward``:
on a CUDA tensor that is kernel A for the log-mel and MFCC patterns.

:class:`StreamingSession` is the live, chunk-by-chunk half: the chain's
streaming state, replaced by every step, and a session-owned generator.

``mesh=`` (a ``DeviceMesh``, ``parallel/mesh.py``) serves over the ranks of
the mesh axis ``shard_axis``: both directions of the server, and the live
session's steps, run each rank's slice of the leading batch axis under
``parallel.shard_map_batch`` (no collective), and return ``DTensor`` s sharded
on the batch axis.  Every batch bucket must divide by the axis size.  A request
short of its batch bucket is padded globally and its rows are gathered for the
trim (one all-gather); at the ladder's batch sizes nothing crosses ranks.
Phaseless inverts and decodes draw from a generator of each shard's own
(``parallel.sharding.shard_generator``).
"""
from __future__ import annotations

import copy
import warnings
from typing import Dict, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F

from .fuse import fusable, fuse_forward
from .transforms.base import AudioTransform
from .transforms.spectral_repr import SpectralRepresentation
from .utils.bucketing import default_buckets

__all__ = ["CompiledTransform", "StreamingSession"]

def _meta_copy(transform: AudioTransform) -> AudioTransform:
    """A copy of ``transform`` on the ``meta`` device: its buffers become
    meta tensors (none is copied on the card) and every transform's
    ``device`` is ``meta``."""
    memo = {id(b): torch.empty_like(b, device="meta") for b in transform.buffers()}
    meta = copy.deepcopy(transform, memo)
    for mod in meta.modules():
        if isinstance(mod, AudioTransform):
            mod.device = torch.device("meta")
    return meta


def _on_local(y, axis_slices, op):
    """``op`` on the local tensor of a ``DTensor`` (a sharded server's
    output), its placements kept; a dim that ``axis_slices`` changes and that
    is sharded is gathered first (an all-gather)."""
    from torch.distributed.tensor import DTensor, Replicate

    if any(p.is_shard() and p.dim in axis_slices for p in y.placements):
        y = y.redistribute(y.device_mesh, [Replicate()] * y.device_mesh.ndim)
    return DTensor.from_local(op(y.to_local()), y.device_mesh, y.placements, run_check=False)


def _pad(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """Zero-pad axis ``axis`` (non-negative) of ``x`` at its end to ``to``."""
    extra = to - x.shape[axis]
    if extra == 0:
        return x
    if type(x) is not torch.Tensor:
        return _on_local(x, {axis}, lambda t: _pad(t, axis, t.shape[axis] + extra))
    pads = [0, 0] * (x.ndim - 1 - axis) + [0, extra]
    return F.pad(x, pads)


class CompiledTransform:
    """Bucketed forward / invert server for a fitted transform.

    Example::

        server = CompiledTransform(chain, buckets=(44100, 88200), batch_sizes=(1, 8))
        server.warmup()                      # every (batch, bucket) pair, both ways
        y = server.forward(x)                # any length / batch <= the ladder maxima
        rec = server.invert(y)               # same discipline on the way back

    The chain must preserve the leading batch axis.  ``Mono`` reads dim -2
    as channels, so a batch of mono signals through it must be ``(B, 1, L)``.

    Boundary semantics (both directions): positions within one analysis
    window of the true signal / frame end see the zero bucket padding instead
    of the unpadded edge handling; interior positions equal the unbucketed
    call's.
    """

    def __init__(
        self,
        transform: AudioTransform,
        buckets: Sequence[int] = (),
        batch_sizes: Sequence[int] = (1, 4, 16),
        inversion_mode: Optional[str] = None,
        frame_axis: Optional[int] = None,
        mesh=None,
        shard_axis: str = "data",
    ):
        self.mesh, self.shard_axis = mesh, shard_axis
        if mesh is not None:
            n = mesh.size(list(mesh.mesh_dim_names).index(shard_axis))
            bad = [b for b in batch_sizes if b % n]
            if bad:
                raise ValueError(
                    "CompiledTransform(mesh=): batch_sizes %r do not divide the mesh axis %r "
                    "(size %d); pick multiples of the mesh size" % (bad, shard_axis, n)
                )
        self.transform = transform
        # sorted: _bucket's ladder-exceeded error reads buckets[-1] as the max
        self.buckets = tuple(sorted(buckets)) if buckets else default_buckets(max_seconds=30.0)
        self.batch_sizes = tuple(sorted(batch_sizes))
        # tuple-output chains have no single frame axis or trimmable shape
        children = list(transform.transforms) if hasattr(transform, "transforms") else [transform]
        for t in children:
            if isinstance(t, SpectralRepresentation) and t.stack is None:
                raise ValueError(
                    "CompiledTransform cannot serve tuple-output representations (%s with "
                    "stack=None); construct it with stack=-2 (the default) or another axis"
                    % type(t).__name__
                )
        self.inversion_mode = inversion_mode
        #: frame axis of the chain output (negative), chain-folded from
        #: ``output_frame_axis`` unless given
        self.frame_axis = int(frame_axis) if frame_axis is not None else transform.output_frame_axis(None)
        self._fused = fusable(transform)
        #: the ``(shape, dtype)`` of every input handed to the chain, per
        #: direction: after :meth:`warmup` no request adds one
        self.shapes: Dict[str, Set[Tuple[Tuple[int, ...], torch.dtype]]] = {"forward": set(), "invert": set()}
        self.refresh()

    # ----------------------------------------------------------------- state
    def refresh(self) -> None:
        """Re-snapshot the (possibly refit) transform: both directions serve
        the copy taken here."""
        self._frozen = frozen = copy.deepcopy(self.transform)
        mode = self.inversion_mode
        fwd = fuse_forward(frozen) if self._fused else frozen.forward
        if self.mesh is None:
            self._fwd = fwd
            self._inv = lambda y: frozen.invert(y, inversion_mode=mode)
        else:
            from .parallel.sharding import shard_map_batch

            self._fwd = shard_map_batch(fwd, self.mesh, self.shard_axis)
            inv = shard_map_batch(lambda v, g: frozen.invert(v, inversion_mode=mode, generator=g),
                                  self.mesh, self.shard_axis, keyed=True)
            self._inv = lambda y: inv(y, None)
        self._meta: Optional[AudioTransform] = None
        self._shape_cache: Dict = {}
        self._t_ladder_cache: Optional[Tuple[int, ...]] = None

    def _run_forward(self, x: torch.Tensor) -> torch.Tensor:
        self.shapes["forward"].add((tuple(x.shape), x.dtype))
        return self._fwd(x)

    def _run_invert(self, y: torch.Tensor) -> torch.Tensor:
        self.shapes["invert"].add((tuple(y.shape), y.dtype))
        return self._inv(y)

    # ------------------------------------------------------------- shaping
    def _meta_forward_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Output shape of the served forward at input ``shape``, from the
        snapshot on the ``meta`` device (float32: the forward's output shape
        does not depend on the input's dtype)."""
        if self._meta is None:
            self._meta = _meta_copy(self._frozen)
        fwd = fuse_forward(self._meta, backend="eager") if self._fused else self._meta.forward
        out = fwd(torch.empty(shape, dtype=torch.float32, device="meta"))
        if not isinstance(out, torch.Tensor):
            raise ValueError("CompiledTransform needs a single-tensor chain output, got %s" % type(out).__name__)
        return tuple(out.shape)

    def _bucket(self, n: int) -> int:
        fitting = [b for b in self.buckets if b >= n]
        if not fitting:
            raise ValueError("length %d exceeds the bucket ladder (max %d)" % (n, self.buckets[-1]))
        return min(fitting)

    def _frames_for_bucket(self, nb: int) -> int:
        """Frame count the chain's forward produces for a bucket, from the
        chain itself (the smallest input layout it takes), not a formula: a
        ``Window`` chain yields ``(nb - size) // hop + 1``, a centred STFT
        ``nb // hop + 1``, a bin-major MFCC puts frames on -1."""
        last_exc = None
        for shape in ((1, nb), (1, 1, nb), (1, 2, nb)):
            try:
                out = self._meta_forward_shape(shape)
                return out[len(out) + self.frame_axis]
            except Exception as e:  # layout probe: next candidate
                last_exc = e
        warnings.warn(
            "CompiledTransform frame ladder: the meta probes failed (%s: %s); falling back "
            "to the centre-padded STFT formula, which may not match this chain's frame count"
            % (type(last_exc).__name__, last_exc),
            RuntimeWarning,
        )
        return nb // int(self._frozen.ratio) + 1

    def _t_ladder(self) -> Tuple[int, ...]:
        if self._t_ladder_cache is None:
            self._t_ladder_cache = tuple(sorted({self._frames_for_bucket(nb) for nb in self.buckets}))
        return self._t_ladder_cache

    def _t_bucket(self, t: int) -> int:
        ladder = self._t_ladder()
        fitting = [b for b in ladder if b >= t]
        if not fitting:
            raise ValueError("frame count %d exceeds the frame ladder (max %d)" % (t, ladder[-1]))
        return min(fitting)

    def _batch(self, b: int) -> int:
        fitting = [s for s in self.batch_sizes if s >= b]
        if not fitting:
            raise ValueError("batch %d exceeds configured batch_sizes (max %d)" % (b, self.batch_sizes[-1]))
        return min(fitting)

    def _true_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        """Output shape of the *unbucketed* forward (cached per input shape)."""
        key = tuple(x.shape)
        if key not in self._shape_cache:
            self._shape_cache[key] = self._meta_forward_shape(key)
        return self._shape_cache[key]

    @staticmethod
    def _trim(y: torch.Tensor, true_shape: Tuple[int, ...]) -> torch.Tensor:
        if y.ndim != len(true_shape):
            # the padding changed the chain's structure (a (C, L) input whose
            # channel axis was padded as if it were a batch axis): never trim
            raise ValueError(
                "bucketed output rank %d != unbucketed rank %d: the leading axis of the "
                "input must be a true batch axis (use (B, C, L) for channel chains; see "
                "CompiledTransform docs)" % (y.ndim, len(true_shape))
            )
        cut = {d: slice(0, t) for d, (s, t) in enumerate(zip(y.shape, true_shape)) if t < s}
        index = tuple(cut.get(d, slice(None)) for d in range(y.ndim))
        if type(y) is not torch.Tensor:
            return _on_local(y, set(cut), lambda t: t[index]) if cut else y
        return y[index]

    # ----------------------------------------------------------------- api
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Forward with bucket padding; output trimmed to the true shape.

        ``x`` may be int16 PCM (read as ``x / 32768``) when the chain serves
        through the fused forward: bit-identical to pre-converting (padding
        with PCM zeros is exact).  Warm its shapes with
        ``warmup(dtypes=(torch.float32, torch.int16))``."""
        if x.dtype == torch.int16 and not self._fused:
            # an unmatched chain would compute on unscaled integers
            raise ValueError(
                "int16 PCM serving requires a fused-matched chain; convert to float32 / 32768 "
                "for %r" % type(self.transform).__name__
            )
        b, n = x.shape[0], x.shape[-1]
        xp = _pad(_pad(x, 0, self._batch(b)), x.ndim - 1, self._bucket(n))
        return self._trim(self._run_forward(xp), self._true_shape(x))

    def invert(self, y: torch.Tensor) -> torch.Tensor:
        """Invert with the same shape discipline as :meth:`forward`: the frame
        axis padded to the frame-count ladder, the batch axis to the batch
        ladder."""
        ratio = int(self._frozen.ratio)
        if ratio > 1:
            if self.frame_axis is None:
                raise ValueError(
                    "cannot locate the frame axis of this chain's output; pass frame_axis= "
                    "to CompiledTransform to enable the bucketed invert"
                )
            axis = y.ndim + self.frame_axis
            t = y.shape[axis]
            tb = self._t_bucket(t)
        else:
            axis, t = y.ndim - 1, y.shape[-1]
            tb = self._bucket(t)
        b = y.shape[0]
        out = self._run_invert(_pad(_pad(y, 0, self._batch(b)), axis, tb))
        true = (b,) + tuple(out.shape[1:-1]) + (out.shape[-1] - (tb - t) * ratio,)
        return self._trim(out, true)

    def warmup(self, channels: Tuple[int, ...] = (), dtypes: Sequence[torch.dtype] = (torch.float32,)) -> int:
        """Run every (batch, bucket) input shape ahead of time: forwards and,
        for invertible chains, the matching inverses.

        ``dtypes`` lists the input dtypes production will send (add
        ``torch.int16`` for raw PCM); inverses run once, for the first: the
        forward's output dtype does not depend on the input's.  Returns the
        number of calls made."""
        count = 0
        dev = self._frozen.device
        for i, dt in enumerate(dtypes):
            if dt == torch.int16 and not self._fused:
                raise ValueError("int16 PCM serving requires a fused-matched chain (see forward)")
            for bb in self.batch_sizes:
                for nb in self.buckets:
                    y = self._run_forward(torch.zeros((bb,) + tuple(channels) + (nb,), dtype=dt, device=dev))
                    count += 1
                    if i == 0 and self._frozen.invertible:
                        # the bucketed forward output is the bucketed invert input
                        self._run_invert(y)
                        count += 1
        return count


class StreamingSession:
    """Live chunk-by-chunk serving of a streaming chain.

    The scan entry points (``streaming.scan_forward`` / ``scan_invert`` /
    ``scan_roundtrip``) take a whole recorded signal; a live stream arrives
    one chunk at a time from an audio callback.  This class holds the chain's
    streaming state (ring buffers, RT-PGHI history, sinebank continuity) and
    runs the chain's eager ``step`` / ``step_invert`` per chunk, the state
    replaced by each call (no growth from chunk to chunk):

    * :meth:`encode`: ``chain.step`` (audio chunk -> frames / features);
    * :meth:`decode`: ``chain.step_invert`` (frames -> audio chunk) with the
      session's own ``torch.Generator``, seeded at construction from
      ``seed``: each call draws from it what its mode needs, the twin of the
      JAX session's iterated key split;
    * :meth:`process`: both, the realtime loop.

    Semantics equal an eager loop of ``step`` / ``step_invert`` with a
    generator seeded alike.
    """

    def __init__(
        self,
        transform: AudioTransform,
        chunk_size: int,
        batch_shape: Tuple[int, ...] = (),
        inversion_mode: Optional[str] = None,
        seed: int = 0,
        mesh=None,
        shard_axis: str = "data",
    ):
        self.transform = transform
        self.chunk_size = int(chunk_size)
        self.inversion_mode = inversion_mode
        self.batch_shape = tuple(batch_shape)
        self.state = transform.init_state(self.batch_shape, mode=inversion_mode)
        self.generator = torch.Generator(device=transform.device).manual_seed(int(seed))
        self._n_chunks = 0  # chunks encoded since reset (time threading)
        self._chunk_tmap: Optional[torch.Tensor] = None
        mode = inversion_mode
        if mesh is None:
            self._step = lambda st, x: transform.step(st, x)
            self._step_invert = lambda st, y, g: transform.step_invert(st, y, inversion_mode=mode, generator=g)
        else:
            # each rank steps its local sessions; the transform is
            # snapshotted here (a refit needs a new session)
            from .parallel.sharding import shard_map_batch

            if not self.batch_shape:
                raise ValueError(
                    "StreamingSession(mesh=) needs a batched session (batch_shape with a "
                    "leading axis divisible by the mesh axis)"
                )
            frozen = copy.deepcopy(transform)
            step = shard_map_batch(lambda x, st: frozen.step(st, x), mesh, shard_axis)
            inv = shard_map_batch(
                lambda y, g, st: frozen.step_invert(st, y, inversion_mode=mode, generator=g),
                mesh, shard_axis, keyed=True,
            )
            self._step = lambda st, x: step(x, st)
            self._step_invert = lambda st, y, g: inv(y, g, st)

    def reset(self, batch_shape: Optional[Tuple[int, ...]] = None) -> None:
        """Fresh streaming state (a new utterance); the generator runs on."""
        if batch_shape is not None:
            self.batch_shape = tuple(batch_shape)
        self.state = self.transform.init_state(self.batch_shape, mode=self.inversion_mode)
        self._n_chunks = 0

    def encode(self, chunk: torch.Tensor, with_time: bool = False):
        """One analysis step: ``(..., chunk_size)`` audio -> frames.

        ``with_time=True`` returns ``(frames, times)``: the frame-start
        seconds of this chunk (``streaming.session_frame_times``), counted
        from the session's chunk counter (``reset`` rewinds it), as a float32
        CPU tensor (the audio callback pays no device trip for them)."""
        if with_time and self._chunk_tmap is None:
            from .streaming import session_frame_times

            self._chunk_tmap = session_frame_times(self.transform, self.chunk_size, 1).cpu()
        self.state, y = self._step(self.state, chunk)
        n = self._n_chunks
        self._n_chunks += 1
        if not with_time:
            return y
        return y, self._chunk_tmap + n * (self.chunk_size / float(self.transform.sr))

    def decode(self, frames: torch.Tensor) -> torch.Tensor:
        """One synthesis step: frames / features -> ``(..., chunk)`` audio."""
        self.state, rec = self._step_invert(self.state, frames, self.generator)
        return rec

    def process(self, chunk: torch.Tensor) -> torch.Tensor:
        """Roundtrip one chunk (phaseless when ``inversion_mode`` is set)."""
        y = self.encode(chunk)
        if self.inversion_mode is not None and y.is_complex():
            y = y.abs()
        return self.decode(y)

    def warmup(self) -> None:
        """Run both directions once ahead of the first live chunk (zeros
        through one process step), then restore the state and the
        generator."""
        g0 = self.generator.get_state()
        self.process(torch.zeros(self.batch_shape + (self.chunk_size,), device=self.transform.device))
        if self.transform.device.type == "cuda":
            torch.cuda.synchronize(self.transform.device)
        self.reset()
        self.generator.set_state(g0)
