"""Deployment: transform checkpoints and program export (twin of the JAX
``export.py``).

* ``save_transform`` / ``load_transform``: a transform (or chain) as one
  ``.npz``, array leaves plus a JSON manifest of classes and configuration.
  No pickle.  The file format is the JAX package's: the manifest names each
  transform by the JAX package's module and class (``"module":
  "acids_transforms_tpu.transforms.stft", "cls": "STFT"``), its ``aux`` holds
  exactly the configuration the JAX class's ``_tree_flatten`` gives, and its
  ``leaves`` the arrays under the JAX leaf names.  So a checkpoint written by
  either package loads in the other.  The loader maps the names onto the
  port's classes through a table (it imports nothing named in the file),
  builds each transform from its configuration and writes the arrays through
  ``convert.load_jax_state``.

  The JAX STFT family keeps a PRNG key leaf ``rng`` (``uint32[2]``) where the
  port keeps an integer ``seed`` that its random inversion modes derive their
  generators from.  The writer stores ``[seed >> 32, seed & 0xffffffff]``,
  which is ``jax.random.PRNGKey(seed)`` for any seed below 2**32; the reader
  takes a key back as the 64-bit seed ``hi << 32 | lo``.  A key the JAX
  package has split since (after eager random inversions) gives some other
  seed: the draws of the two packages never agree anyway.

* ``export_program`` / ``load_program``: ``torch.export`` a forward (or any
  callable on tensors) to a serialized ``ExportedProgram``, loadable without
  the transform classes.  The callable's tensors that are no input (fitted
  statistics, windows, banks) become the program's constants.  Kernel A is a
  registered operator (``ops/cuda/spectral.py:fused_melspec_op``), so
  ``fuse_forward(chain, backend="kernel")`` exports with one
  ``acids_transforms_tpu_torch::fused_melspec`` node that launches A when the
  loaded program runs on the card.

* ``invert_with_phase_fn``: the deployable ``(features, phase) -> audio``
  inverse of a spectral chain.

  ``in_shardings=`` exports a multi-device program: ``torch.export`` takes no
  ``DTensor``, so the program is the per-shard one, exported at the local
  batch, and the archive records the mesh axis, its size and the placements
  (``sharding.json``).  :func:`load_program` then returns a callable that runs
  it under ``parallel.shard_map_batch`` on any mesh with an axis of that size.
"""
from __future__ import annotations

import inspect
import io
import json
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .convert import load_jax_state, state_from_leaves
from .ops.cuda import spectral as _spectral  # noqa: F401  (registers the operator a program may hold)
from .transforms.base import AudioTransform, ComposeAudioTransform
from .transforms.dgt import DGT, RealtimeDGT
from .transforms.mel import MFCC
from .transforms.misc import OneHot, Squeeze, Transpose, Unsqueeze
from .transforms.norm import Normalize
from .transforms.oadd import OverlapAdd
from .transforms.raw import MidSide, Mono, MuLaw, Stereo, Window
from .transforms.spectral_repr import (
    IF,
    Cartesian,
    Dummy,
    Imaginary,
    Magnitude,
    Phase,
    Polar,
    PolarIF,
    Real,
    SpectralRepresentation,
    _Representation,
)
from .transforms.stft import STFT, RealtimeSTFT

__all__ = [
    "save_transform",
    "load_transform",
    "export_program",
    "load_program",
    "invert_with_phase_fn",
]

#: the format's name of each class: the JAX package's module and class
_FORMAT_PACKAGE = "acids_transforms_tpu.transforms"
_FORMAT_NAMES: Dict[type, Tuple[str, str]] = {
    cls: ("%s.%s" % (_FORMAT_PACKAGE, cls.__module__.rsplit(".", 1)[1]), cls.__qualname__)
    for cls in (
        ComposeAudioTransform, Mono, Stereo, MidSide, Window, MuLaw, STFT, RealtimeSTFT, DGT,
        RealtimeDGT, MFCC, Dummy, Real, Imaginary, Magnitude, Phase, IF, Cartesian, Polar, PolarIF,
        Normalize, OverlapAdd, Unsqueeze, Squeeze, Transpose, OneHot,
    )
}
_CLASSES = {name: cls for cls, name in _FORMAT_NAMES.items()}

#: the JAX leaf names, in order, by the class that declares them
_LEAVES: Dict[type, Tuple[str, ...]] = {
    ComposeAudioTransform: ("transforms",),
    STFT: ("window", "inv_window", "rng"),
    MFCC: ("window", "mel_bank", "dct_mat", "norm"),
    Magnitude: ("norm", "mel_bank", "inverse_mel_bank"),
    _Representation: ("norm",),
    SpectralRepresentation: ("magnitude", "phase"),
    Normalize: ("offset", "scale"),
}
#: attributes of the port that are no configuration of the format
_PORT_ONLY = {"device", "training", "seed"}
#: private attributes the JAX classes keep as configuration
_PRIVATE_AUX = {"_window_taps", "_inv_window_taps"}
#: constructor arguments named otherwise in the configuration
_RENAMED = {"window": "window_name", "contrast": "contrast_mode"}


def _leaves_of(cls: type) -> Tuple[str, ...]:
    for c in cls.__mro__:
        if c in _LEAVES:
            return _LEAVES[c]
    return ()


def _hashable(value: Any) -> Any:
    """Configuration values as the JAX package's pytree aux holds them."""
    if isinstance(value, list):
        return ("__list__", tuple(_hashable(v) for v in value))
    if isinstance(value, tuple):
        return ("__tuple__", tuple(_hashable(v) for v in value))
    if isinstance(value, dict):
        return ("__dict__", tuple(sorted((k, _hashable(v)) for k, v in value.items())))
    return value


def _unhashable(value: Any) -> Any:
    if isinstance(value, tuple) and len(value) == 2 and value[0] in ("__list__", "__tuple__", "__dict__"):
        tag, payload = value
        if tag == "__list__":
            return [_unhashable(v) for v in payload]
        if tag == "__tuple__":
            return tuple(_unhashable(v) for v in payload)
        return {k: _unhashable(v) for k, v in payload}
    return value


def _jsonable(v: Any) -> Any:
    """Aux values are hashable trees; make them JSON-round-trippable."""
    if isinstance(v, tuple):
        return {"__tuple__": [_jsonable(x) for x in v]}
    return v


def _unjsonable(v: Any) -> Any:
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_unjsonable(x) for x in v["__tuple__"])
    return v


def _aux_of(t: AudioTransform) -> Tuple[Tuple[str, Any], ...]:
    """The configuration the JAX twin's ``_tree_flatten`` gives: every
    attribute but the leaves, sorted by name."""
    skip = set(_leaves_of(type(t))) | _PORT_ONLY
    items = []
    for k, v in vars(t).items():
        if k in skip or (k.startswith("_") and k not in _PRIVATE_AUX):
            continue
        items.append((k, _hashable(v)))
    return tuple(sorted(items))


def _seed_key(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _encode(obj: Any, arrays: Dict[str, np.ndarray], path: str) -> Any:
    """Recursively encode a transform into JSON + a flat array dict."""
    if isinstance(obj, AudioTransform):
        cls = type(obj)
        if cls not in _FORMAT_NAMES:
            raise TypeError("cannot serialize %s: the checkpoint format has no such class" % cls.__name__)
        module, name = _FORMAT_NAMES[cls]
        leaves = {}
        for leaf in _leaves_of(cls):
            value = _seed_key(obj.seed) if leaf == "rng" else getattr(obj, leaf)
            if isinstance(value, torch.nn.ModuleList):
                value = list(value)
            leaves[leaf] = _encode(value, arrays, "%s/%s" % (path, leaf))
        return {
            "__kind__": "transform",
            "module": module,
            "cls": name,
            "aux": [[k, _jsonable(v)] for k, v in _aux_of(obj)],
            "leaves": leaves,
        }
    if obj is None:
        return {"__kind__": "none"}
    if isinstance(obj, (list, tuple)):
        return {
            "__kind__": "list" if isinstance(obj, list) else "tuple",
            "items": [_encode(v, arrays, "%s/%d" % (path, i)) for i, v in enumerate(obj)],
        }
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray) or np.isscalar(obj):
        arrays[path] = np.asarray(obj)
        return {"__kind__": "array", "key": path}
    raise TypeError("cannot serialize leaf of type %s" % type(obj))


def _decode_leaf(spec: Any, arrays, device) -> Any:
    kind = spec["__kind__"]
    if kind == "transform":
        return _decode_transform(spec, arrays, device)
    if kind == "none":
        return None
    if kind in ("list", "tuple"):
        items = [_decode_leaf(s, arrays, device) for s in spec["items"]]
        return items if kind == "list" else tuple(items)
    if kind == "array":
        return np.asarray(arrays[spec["key"]])
    raise ValueError("unknown spec kind %r" % kind)


def _decode_transform(spec: Any, arrays, device) -> AudioTransform:
    key = (spec["module"], spec["cls"])
    if key not in _CLASSES:
        raise ValueError("the checkpoint names %s.%s, which the port has no class for" % key)
    cls = _CLASSES[key]
    aux = {k: _unhashable(_unjsonable(v)) for k, v in spec["aux"]}
    leaves = {name: _decode_leaf(s, arrays, device) for name, s in spec["leaves"].items()}
    if cls is ComposeAudioTransform:
        return ComposeAudioTransform(leaves["transforms"], sr=aux.get("sr", 44100), device=device)
    params = inspect.signature(cls.__init__).parameters
    kwargs = {p: aux[_RENAMED.get(p, p)] for p in params if p != "self" and _RENAMED.get(p, p) in aux}
    obj = cls(device=device, **kwargs)
    for k, v in aux.items():
        setattr(obj, k, v)
    arrays_of = {}
    for name, value in leaves.items():
        if name == "rng":
            hi, lo = (int(v) for v in np.asarray(value, dtype=np.uint64).reshape(-1)[-2:])
            obj.seed = (hi << 32) | lo
        elif isinstance(value, AudioTransform) or value is None:
            setattr(obj, name, value)
        else:
            arrays_of[name] = value
    if arrays_of:
        load_jax_state(obj, state_from_leaves([arrays_of]))
    return obj


def save_transform(transform: AudioTransform, path: str) -> None:
    """Serialize a transform (or chain) to ``path`` (.npz), in the format the
    JAX package's ``save_transform`` writes."""
    arrays: Dict[str, np.ndarray] = {}
    manifest = _encode(transform, arrays, "root")
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def load_transform(path: str, device=None) -> AudioTransform:
    """Load a transform saved by :func:`save_transform` of either package,
    built for ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
        if manifest.get("__kind__") != "transform":
            raise ValueError("the checkpoint holds no transform")
        return _decode_transform(manifest, data, dev)


_SHARDING = "sharding.json"


class _Program(torch.nn.Module):
    """A callable as a module for ``torch.export``.  The callable is kept out
    of the module's registry, so that the tensors it reads become the
    program's constants rather than its buffers."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.__dict__["fn"] = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(
    fn: Callable,
    example_args: Sequence[torch.Tensor],
    path: Optional[str] = None,
    polymorphic_batch: bool = False,
    in_shardings: Any = None,
) -> bytes:
    """Serialize ``torch.export`` of ``fn(*example_args)`` to bytes (also
    written to ``path`` when given).

    ``fn`` is e.g. ``fuse_forward(fitted)`` or ``lambda x: chain.forward(x)``
    with a fitted chain closed over: its parameters become constants.  The
    input dtypes come from the example arguments (an int16 example exports
    the raw-PCM ingest).  ``polymorphic_batch=True`` marks the leading axis
    of every argument as one dynamic dimension, so one program serves any
    batch size (sample-axis lengths stay static: bucket them with
    ``utils/bucketing.py``).

    ``in_shardings`` (a 1-D ``DeviceMesh``, or ``(mesh, axis_name)``) shards
    the leading batch axis of every argument over the axis: the program is
    exported at the local batch ``B / n`` and runs per shard once loaded
    (cannot be combined with ``polymorphic_batch``)."""
    extra = None
    if in_shardings is not None:
        if polymorphic_batch:
            raise ValueError("polymorphic_batch and in_shardings are exclusive")
        mesh, axis = in_shardings if isinstance(in_shardings, tuple) else (
            in_shardings, in_shardings.mesh_dim_names[0])
        n = mesh.size(list(mesh.mesh_dim_names).index(axis))
        B = example_args[0].shape[0]
        if any(a.shape[0] != B for a in example_args) or B % n:
            raise ValueError(
                "export_program(in_shardings=): every argument needs the leading batch %d, "
                "divisible by mesh axis %r size %d" % (B, axis, n)
            )
        example_args = [a.narrow(0, 0, B // n) for a in example_args]
        extra = {_SHARDING: json.dumps({"axis": axis, "mesh_size": n, "batch": B,
                                        "placements": ["Shard(0)"] * len(example_args)})}
    dynamic = None
    if polymorphic_batch:
        batch = torch.export.Dim("batch", min=1)
        dynamic = (tuple({0: batch} for _ in example_args),)  # the one *args of _Program.forward
    program = torch.export.export(_Program(fn), tuple(example_args), dynamic_shapes=dynamic)
    # the example arguments are not part of the program (saved, a view would
    # carry its whole storage along)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files=extra)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class ShardedProgram:
    """A program exported with ``in_shardings``: called with global tensors
    (or ``DTensor`` s sharded on dim 0), it runs the per-shard program on each
    rank's batch slice under ``parallel.shard_map_batch`` and returns
    ``DTensor`` s.  ``mesh=None`` builds a 1-D mesh over the process group at
    the first call, on the device type of the first argument."""

    def __init__(self, module: torch.nn.Module, sharding: dict, mesh=None):
        self.module, self.sharding, self.mesh = module, sharding, mesh
        self.graph = module.graph
        self._call = None

    def __call__(self, *args):
        if self._call is None:
            from .parallel import make_mesh, shard_map_batch

            axis, n = self.sharding["axis"], self.sharding["mesh_size"]
            if self.mesh is None:
                self.mesh = make_mesh({axis: n}, device_type=args[0].device.type)
            names = list(self.mesh.mesh_dim_names or ())
            if axis not in names or self.mesh.size(names.index(axis)) != n:
                raise ValueError(
                    "the program was exported for a mesh axis %r of size %d; this mesh has %r"
                    % (axis, n, dict(zip(names, self.mesh.mesh.shape)))
                )
            self._call = shard_map_batch(self.module, self.mesh, axis)
        return self._call(*args)


def load_program(path_or_bytes, mesh=None) -> Callable:
    """Load a program written by :func:`export_program` as a callable module
    (its graph: ``.graph``); a program exported with ``in_shardings`` comes
    back as a :class:`ShardedProgram` over ``mesh``."""
    extra = {_SHARDING: ""}
    if isinstance(path_or_bytes, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(path_or_bytes)), extra_files=extra)
    else:
        program = torch.export.load(path_or_bytes, extra_files=extra)
    if extra[_SHARDING]:
        return ShardedProgram(program.module(), json.loads(extra[_SHARDING]), mesh)
    return program.module()


def invert_with_phase_fn(chain: AudioTransform) -> Callable:
    """The deployable ``(y, phase) -> audio`` inverse of a spectral chain.

    The phase stash of an eager STFT (``keep_input``) is a side channel a
    deployed program does not have; this entry point takes the phase
    explicitly, so a host can do the phase-faithful inversion.  For a complex
    spectrogram ``spec`` call it as ``fn(spec.abs(), spec.angle())``.

    ``chain`` must hold exactly one STFT-family transform (STFT, DGT or their
    realtime variants): the transforms after it are inverted first (denorm,
    contrast, inverse mel), then ``y cos(phase) + i y sin(phase)`` goes
    through the spectral inverse and the leading transforms' inverses."""
    ts = list(chain.transforms) if isinstance(chain, ComposeAudioTransform) else [chain]
    spectral = [i for i, t in enumerate(ts) if isinstance(t, STFT)]
    if len(spectral) != 1:
        raise ValueError(
            "invert_with_phase_fn needs exactly one STFT/DGT in the chain (got %d)" % len(spectral)
        )
    idx = spectral[0]
    pre, spec_t, post = ts[:idx], ts[idx], ts[idx + 1:]

    def invert(y: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        for t in reversed(post):
            y = t.invert(y)
        phase = phase.to(torch.float32)
        x = spec_t.invert(torch.complex(y * torch.cos(phase), y * torch.sin(phase)))
        for t in reversed(pre):
            x = t.invert(x)
        return x

    return invert
