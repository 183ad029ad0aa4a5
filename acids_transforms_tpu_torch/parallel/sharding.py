"""Sharded execution of transform chains (twin of the JAX
``parallel/sharding.py``).

The JAX package partitions with ``shard_map`` over a ``Mesh``; here every
rank of a ``torch.distributed`` process group runs the same program, and a
``DeviceMesh`` (``parallel/mesh.py``) names its axes.  Two modes:

* **batch (data) parallelism**, the production mode: each rank runs the
  single-device call (kernels included) on its slice of the leading batch
  axis and issues no collective at all.  Inputs are either a plain tensor
  that every rank holds whole (each takes its slice, no traffic) or a
  ``DTensor`` sharded on dim 0; outputs are ``DTensor`` s built from the local
  results (``Shard(0)`` on the axis, ``Replicate`` elsewhere), without a
  collective.  ``y.to_local()`` is the rank's part, ``y.full_tensor()`` the
  whole (an all-gather the caller asks for).
* **sequence parallelism**, for single long signals: the time axis is
  sharded and each rank trades the ``n_fft - hop`` halo with its neighbours
  on the axis (``dist.batch_isend_irecv``: NVLink P2P under NCCL), so the
  framing (analysis) and the overlap-add (synthesis) are exact at the shard
  boundaries.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..ops.fft import irfft_frames, rfft_frames
from ..ops.framing import frame, overlap_add

__all__ = [
    "shard_along",
    "data_parallel",
    "shard_map_batch",
    "sequence_parallel_stft",
    "sequence_parallel_istft",
]

_MASK63 = (1 << 63) - 1
_MASK64 = (1 << 64) - 1


def _dt():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return DTensor, Replicate, Shard


def _axis(mesh, axis_name: str) -> Tuple[int, int, int]:
    """``(mesh dim, axis size, this rank's index on the axis)``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError("the mesh has no axis %r (its axes: %r)" % (axis_name, names))
    d = names.index(axis_name)
    return d, mesh.size(d), mesh.get_local_rank(axis_name)


def _placements(mesh, shards: Dict[int, int]) -> list:
    """Per mesh dim ``Shard(tensor dim)`` where ``shards`` maps it, else
    ``Replicate()``."""
    _, Replicate, Shard = _dt()
    return [Shard(shards[d]) if d in shards else Replicate() for d in range(mesh.ndim)]


def _to_local(leaf, mesh, shards: Dict[int, int]):
    """This rank's part of ``leaf`` under ``shards`` (mesh dim -> tensor
    dim): a plain tensor is held whole by every rank and sliced here; a
    ``DTensor`` must carry those placements (its local tensor is returned)
    or be replicated (then sliced like a plain tensor)."""
    DTensor, _, _ = _dt()
    if isinstance(leaf, DTensor):
        if leaf.device_mesh != mesh:
            raise ValueError("the DTensor input lies on another device mesh")
        want = _placements(mesh, shards)
        if list(leaf.placements) == want:
            return leaf.to_local()
        if any(p.is_shard() for p in leaf.placements):
            raise ValueError(
                "DTensor input placed %r; this call takes %r (or a replicated tensor)"
                % (tuple(leaf.placements), tuple(want))
            )
        leaf = leaf.to_local()
    if not isinstance(leaf, torch.Tensor):
        return leaf
    for d, td in shards.items():
        n, i = mesh.size(d), mesh.get_local_rank(d)
        size = leaf.shape[td] // n
        leaf = leaf.narrow(td, i * size, size)
    return leaf


def _from_local(t: torch.Tensor, mesh, shards: Dict[int, int]):
    DTensor, _, _ = _dt()
    shards = {d: td % t.ndim for d, td in shards.items()}
    return DTensor.from_local(t, mesh, _placements(mesh, shards), run_check=False)


def _check_divides(shape, mesh, shards: Dict[int, int], what: str) -> None:
    for d, td in shards.items():
        n = mesh.size(d)
        if shape[td] % n:
            raise ValueError(
                "%s: dim %d of size %d not divisible by mesh axis %r size %d"
                % (what, td, shape[td], mesh.mesh_dim_names[d], n)
            )


def local_batch(x: torch.Tensor, mesh, axis_name: str, what: str) -> torch.Tensor:
    """This rank's slice of ``x``'s leading batch axis over ``axis_name``
    (rank >= 2, divisible batch: the :func:`shard_map_batch` contract)."""
    d, _, _ = _axis(mesh, axis_name)
    if getattr(x, "ndim", 0) < 2:
        raise ValueError(
            "%s: input must carry an explicit leading batch axis (rank >= 2); got shape %r"
            % (what, tuple(getattr(x, "shape", ())))
        )
    _check_divides(x.shape, mesh, {d: 0}, what)
    return _to_local(x, mesh, {d: 0})


def whole(x):
    """``x`` itself, or the whole of a ``DTensor`` (an all-gather)."""
    DTensor, _, _ = _dt()
    return x.full_tensor() if isinstance(x, DTensor) else x


def shard_along(x: torch.Tensor, mesh, axis_name: str = "data", dim: int = 0):
    """``x`` (held whole, the same, by every rank) as a ``DTensor`` with
    dimension ``dim`` sharded over ``axis_name``: each rank keeps its slice,
    nothing crosses ranks."""
    d, _, _ = _axis(mesh, axis_name)
    dim = dim % x.ndim
    _check_divides(x.shape, mesh, {d: dim}, "shard_along")
    return _from_local(_to_local(x, mesh, {d: dim}).contiguous(), mesh, {d: dim})


def data_parallel(fn: Callable, mesh, axis_name: str = "data", dim: int = 0) -> Callable:
    """``fn(transform, x)`` run by each rank on its slice of ``x`` along
    ``dim``, the transform replicated (every rank holds it whole).  Tensor
    outputs come back sharded along ``dim`` over ``axis_name``::

        fwd = data_parallel(lambda t, x: t.forward(x), mesh)
        y = fwd(chain, x)   # x: (B, ...) with B % mesh axis size == 0
    """
    d, _, _ = _axis(mesh, axis_name)

    def wrapped(t, x):
        td = dim % x.ndim
        _check_divides(x.shape, mesh, {d: td}, "data_parallel")
        out = fn(t, _to_local(x, mesh, {d: td}))
        return pytree.tree_map(
            lambda l: _from_local(l, mesh, {d: td}) if isinstance(l, torch.Tensor) and l.ndim > td else l,
            out,
        )

    return wrapped


def _fold_in(seed: int, index: int) -> int:
    """A seed of its own for shard ``index`` (splitmix64 of the pair)."""
    z = (int(seed) + 0x9E3779B97F4A7C15 * (int(index) + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK63


def shard_generator(generator: Optional[torch.Generator], index: int, device) -> torch.Generator:
    """The generator of shard ``index``: seeded from one draw of the
    caller's ``generator`` (the same on every rank, which hold it alike; 0
    when there is none) with the index folded in, the twin of
    ``jax.random.fold_in(key, axis_index)``.  The shards' draws then differ
    from one device's run in value, not in distribution."""
    if generator is None:
        base = 0
    else:
        base = int(torch.randint(0, 1 << 62, (1,), generator=generator, device=generator.device).item())
    g = torch.Generator(device=device)
    g.manual_seed(_fold_in(base, index))
    return g


def _signature(args) -> tuple:
    leaves, spec = pytree.tree_flatten(args)
    return (str(spec),) + tuple(
        (tuple(l.shape), str(l.dtype), l.device.type) if isinstance(l, torch.Tensor) else (type(l).__name__,)
        for l in leaves
    )


def _probe_shapes(fn: Callable, args: tuple, keyed: bool) -> Optional[List[Optional[tuple]]]:
    """Output leaf shapes of ``fn`` at the GLOBAL argument shapes, from a
    fake-tensor trace (shapes only: no kernel is launched, no data read;
    ``_build.load_library`` refuses under it, ``ops/fft.py`` caches no table).
    ``None`` where the trace cannot run: a kernel wrapper, a host read of
    data.  It runs before the real call, which then overwrites whatever the
    trace left on a module (the STFT's phase stash)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake(l):
        if isinstance(l, torch.Tensor):
            return torch.empty(tuple(l.shape), dtype=l.dtype, device=l.device)
        return l

    try:
        with warnings.catch_warnings(), FakeTensorMode(allow_non_fake_inputs=True):
            warnings.simplefilter("ignore")
            fargs = pytree.tree_map(fake, args)
            if keyed:
                g = torch.Generator(device=fargs[0].device)
                out = fn(fargs[0], g, *fargs[1:])
            else:
                out = fn(*fargs)
            return [tuple(l.shape) if isinstance(l, torch.Tensor) else None for l in pytree.tree_leaves(out)]
    except (RuntimeError, TypeError, ValueError):   # what fake tensors cannot do: a launch, a host read
        return None


def shard_map_batch(fn: Callable, mesh, axis_name: str = "data", keyed: bool = False) -> Callable:
    """Partition a batch-leading function over ``mesh``: each rank runs
    ``fn`` on its LOCAL batch slice, so the kernel wrappers inside it
    (``fuse.fuse_forward``, the streaming session kernels) see ordinary
    tensors on their device and are launched per shard as single-device
    calls, with no collective.

    Leaf rule (the JAX one): every input leaf whose leading dimension equals
    the global batch ``B = x.shape[0]`` is split over ``axis_name`` on dim 0;
    every other leaf is passed whole.  ``x`` needs rank >= 2 and ``B`` must
    divide by the axis size.  An output leaf is batch-sharded when the
    global shapes give it leading dim ``B`` and the local run ``B / n``;
    replicated when both give the same shape.  The global shapes come from a
    fake-tensor trace at the global signature (no kernel runs; kernel A's
    registered operator traces through its fake implementation); where the
    trace cannot run (a ctypes kernel wrapper, a host read), a leaf is
    batch-sharded iff its local leading dim is ``B / n``.  The trace runs once
    per argument signature, before the first real call, and the placements
    are cached.

    ``keyed=True``: ``fn(x, generator, *rest)``; the generator (or None) is
    never cut by the leaf rule: each shard gets one of its own
    (:func:`shard_generator`), so the shards draw independent randomness.

    Channel caveat (``Mono`` semantics): a ``(B, L)`` batch whose local slice
    has exactly 2 rows is indistinguishable from a stereo signal, so chains
    with channels take ``(B, 1, L)`` input under a mesh."""
    d, n, idx = _axis(mesh, axis_name)
    DTensor, _, _ = _dt()
    cache: Dict[tuple, List[bool]] = {}

    def wrapped(x, *rest):
        ndim = getattr(x, "ndim", 0)
        if ndim < 2:
            raise ValueError(
                "shard_map_batch: input must carry an explicit leading batch axis "
                "(rank >= 2); got rank-%d shape %r.  Unbatched signals cannot be "
                "mesh-partitioned: add a batch dim (x[None]) or drop mesh=."
                % (ndim, tuple(getattr(x, "shape", ())))
            )
        B = x.shape[0]
        if B % n:
            raise ValueError(
                "shard_map_batch: leading batch %d not divisible by mesh axis %r size %d"
                % (B, axis_name, n)
            )
        Bl = B // n

        def local(l):
            if isinstance(l, torch.Tensor) and l.ndim >= 1 and l.shape[0] == B:
                return _to_local(l, mesh, {d: 0})
            return _to_local(l, mesh, {}) if isinstance(l, DTensor) else l

        if keyed:
            gen, rest = rest[0], rest[1:]
        args = (x,) + tuple(rest)
        sig = _signature(args)
        flags = cache.get(sig)
        glob = _probe_shapes(fn, args, keyed) if flags is None else None
        largs = pytree.tree_map(local, args)
        if keyed:
            out = fn(largs[0], shard_generator(gen, idx, largs[0].device), *largs[1:])
        else:
            out = fn(*largs)
        leaves, spec = pytree.tree_flatten(out)
        if flags is None:
            flags = [isinstance(l, torch.Tensor) and l.ndim >= 1 and l.shape[0] == Bl for l in leaves]
            if glob is not None and len(glob) == len(leaves):
                flags = []
                for l, gs in zip(leaves, glob):
                    ls = tuple(l.shape) if isinstance(l, torch.Tensor) else None
                    if ls is not None and gs and gs[0] == B and ls == (Bl,) + gs[1:]:
                        flags.append(True)
                    elif gs == ls:
                        flags.append(False)
                    else:
                        raise ValueError(
                            "shard_map_batch: output leaf shape %r (global trace) vs %r "
                            "(local run) is neither batch-sharded nor replicated" % (gs, ls)
                        )
            cache[sig] = flags
        wrapped_leaves = [
            (_from_local(l, mesh, {d: 0} if f else {}) if isinstance(l, torch.Tensor) else l)
            for l, f in zip(leaves, flags)
        ]
        return pytree.tree_unflatten(wrapped_leaves, spec)

    return wrapped


def _shift(t: torch.Tensor, mesh, axis_name: str, to_next: bool) -> torch.Tensor:
    """Pass ``t`` one shard along ``axis_name`` (to ``index + 1`` when
    ``to_next``, else to ``index - 1``) and return what the other neighbour
    sent; zeros where there is no such neighbour.  A rank without a
    neighbour on a side posts nothing there."""
    group = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    i, n = mesh.get_local_rank(axis_name), len(ranks)
    dst, src = (i + 1, i - 1) if to_next else (i - 1, i + 1)
    recv = torch.zeros_like(t)
    ops = []
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[src], group))
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), ranks[dst], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv


def _seq_shards(mesh, axis_name: str, batch_axis: Optional[str], tdim: int) -> Dict[int, int]:
    shards = {_axis(mesh, axis_name)[0]: tdim}
    if batch_axis:
        shards[_axis(mesh, batch_axis)[0]] = 0
    return shards


def sequence_parallel_stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    mesh,
    axis_name: str = "seq",
    impl: str = "auto",
    batch_axis: Optional[str] = None,
):
    """STFT of a time-sharded signal; the output's frame axis is sharded the
    same way.

    ``x (..., L)`` with ``L`` divisible by the axis size times ``hop``; no
    centre padding (``center=False``: pre-pad globally for centred frames).
    Each shard fetches an ``n_fft - hop`` halo from its right neighbour and
    frames locally; every shard has the same frame count, so the result is
    exactly the unsharded STFT of ``x`` with ``L // hop`` frames (the last
    ones framing the zeros past the end).  ``batch_axis`` also shards dim 0."""
    halo = n_fft - hop_length
    shards = _seq_shards(mesh, axis_name, batch_axis, x.ndim - 1)
    _check_divides(x.shape, mesh, shards, "sequence_parallel_stft")
    xs = _to_local(x, mesh, shards)
    L_loc = xs.shape[-1]
    if L_loc % hop_length or halo > L_loc:
        raise ValueError(
            "sequence_parallel_stft: a shard of %d samples must be a multiple of hop %d "
            "and hold the %d-sample halo" % (L_loc, hop_length, halo)
        )
    nxt = _shift(xs[..., :halo], mesh, axis_name, to_next=False)
    xc = torch.cat([xs, nxt], dim=-1)
    frames = frame(xc, n_fft, hop_length, -1)[..., : L_loc // hop_length, :]
    spec = rfft_frames(frames * window, impl=impl)
    return _from_local(spec, mesh, _seq_shards(mesh, axis_name, batch_axis, spec.ndim - 2))


def sequence_parallel_istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    mesh,
    axis_name: str = "seq",
    impl: str = "auto",
    batch_axis: Optional[str] = None,
):
    """Least-squares ISTFT of frame-sharded spectra; the output is
    time-sharded.

    The inverse of :func:`sequence_parallel_stft`: each shard synthesizes and
    overlap-adds its frames, sends the ``n_fft - hop`` overlap-add tail to its
    right neighbour and divides by the squared-window envelope (floored at
    the dtype's ``tiny``).  Every shard has the same frame count, so the
    envelope tail a shard receives is its own and is added locally.  Exact at
    the shard boundaries."""
    halo = n_fft - hop_length
    shards = _seq_shards(mesh, axis_name, batch_axis, spec.ndim - 2)
    _check_divides(spec.shape, mesh, shards, "sequence_parallel_istft")
    sp = _to_local(spec, mesh, shards)
    body_len = sp.shape[-2] * hop_length
    if body_len < halo:
        raise ValueError(
            "sequence_parallel_istft: a shard of %d frames is shorter than the %d-sample halo"
            % (sp.shape[-2], halo)
        )
    ola = overlap_add(irfft_frames(sp, n_fft=n_fft, impl=impl) * window, hop_length)
    prev_tail = _shift(ola[..., body_len:], mesh, axis_name, to_next=True)
    body = ola[..., :body_len].clone()
    body[..., :halo] += prev_tail
    env_ola = overlap_add((window * window).expand(sp.shape[-2], n_fft), hop_length)
    env = env_ola[:body_len].clone()
    if mesh.get_local_rank(axis_name) > 0:
        env[:halo] += env_ola[body_len:]
    tiny = torch.finfo(body.dtype).tiny
    out = body / torch.where(env > tiny, env, torch.ones_like(env))
    return _from_local(out, mesh, _seq_shards(mesh, axis_name, batch_axis, out.ndim - 1))
