"""Weights and state carried across from the JAX package, as numpy arrays.

A chain fitted in the JAX package hands over its array leaves (windows, mel
bank and its inverse, the fitted normalizer's ``offset`` / ``scale``) keyed by
child index and leaf name; :func:`load_jax_state` writes them into the
buffers of a port chain of the same structure.  This module imports neither
package: the caller extracts the leaves (``state_from_leaves`` takes what the
JAX transforms' ``_tree_flatten`` returns, converted to numpy) and hands over
plain arrays.

Keys: ``"<child index>.<leaf>"`` with leaves ``window``, ``inv_window``
(STFT and DGT: the gaussian window and its least-squares inverse window);
``mel_bank``, ``inverse_mel_bank``, ``norm.offset``, ``norm.scale``
(Magnitude; ``Real``, ``Imaginary``, ``Phase`` and ``IF`` have the ``norm.*``
leaves only); ``offset``, ``scale`` (Normalize); the pairs ``Polar``,
``PolarIF`` and ``Cartesian`` nest their two halves under ``magnitude.`` and
``phase.`` (``"<i>.magnitude.mel_bank"``, ``"<i>.magnitude.norm.offset"``,
``"<i>.phase.norm.scale"``, ...); and the flags ``"<i>.needs_scaling"`` and
``"<i>.norm.needs_scaling"`` (``"<i>.phase.norm.needs_scaling"`` in a pair),
0 or 1.  An unnormalized half (``Dummy``) has no leaves.  Streaming chains
(``OverlapAdd``, ``RealtimeSTFT``, ``RealtimeDGT``) have window leaves only.
``MFCC`` has ``window``, ``mel_bank``, ``dct_mat`` (with ``n_mfcc`` set),
and with a norm ``norm.offset``, ``norm.scale`` and ``norm.needs_scaling``.
``OneHot``'s fitted class count is the scalar ``"<i>.n_classes"`` (the JAX
transform keeps it as static config, not a leaf: hand it over as
``{"n_classes": t.n_classes}``).  The raw and layout transforms (``Mono``,
``Stereo``, ``MidSide``, ``Window``, ``MuLaw``, ``Unsqueeze``, ``Squeeze``,
``Transpose``) have no state.

:func:`load_jax_stream_state` carries a streaming session across: the state
that the JAX package's ``chain.init_state`` / ``scan_forward`` return (one
entry per child, a dict of arrays or ``None``), given as numpy arrays, becomes
the port's, so ``streaming.scan_forward(..., state=...)`` or a loop of
``chain.step`` / ``step_invert`` resumes a session the JAX package started (a
``pghi`` session's RT-PGHI history included).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .transforms.base import AudioTransform, ComposeAudioTransform
from .transforms.misc import OneHot
from .transforms.norm import Normalize
from .transforms.stft import STFT, RealtimeSTFT

__all__ = ["load_jax_state", "load_jax_stream_state", "state_from_leaves"]


def state_from_leaves(children: Sequence[Mapping[str, object]]) -> Dict[str, np.ndarray]:
    """Flatten per-child leaf mappings into the keyed state.

    ``children[i]`` maps leaf names of child ``i`` to arrays (anything
    ``np.asarray`` takes), nested mappings for nested transforms (``{"norm":
    {"offset": ..., "scale": ...}}``) and plain bools for flags.  ``None``
    leaves (an unfitted or absent child) are skipped."""
    state: Dict[str, np.ndarray] = {}

    def put(prefix: str, node) -> None:
        for name, val in node.items():
            key = "%s.%s" % (prefix, name)
            if val is None:
                continue
            if isinstance(val, Mapping):
                put(key, val)
            else:
                state[key] = np.asarray(val)

    for i, child in enumerate(children):
        put(str(i), child)
    return state


def _set_buffer(mod: torch.nn.Module, name: str, value: np.ndarray) -> None:
    old = mod._buffers[name]
    new = torch.as_tensor(np.array(value), dtype=old.dtype, device=old.device)
    if tuple(new.shape) != tuple(old.shape):
        raise ValueError(
            "%s.%s: shape %s does not fit the port's %s"
            % (type(mod).__name__, name, tuple(new.shape), tuple(old.shape))
        )
    mod._buffers[name] = new


def load_jax_state(port_chain: AudioTransform, state: Mapping[str, np.ndarray]) -> AudioTransform:
    """Write ``state`` into ``port_chain``'s buffers in place and return it.

    Raises on a key that names no buffer or flag of the chain, so a chain of
    another structure cannot be loaded silently."""
    children = (
        list(port_chain.transforms)
        if isinstance(port_chain, ComposeAudioTransform)
        else [port_chain]
    )
    touched = set()
    for key, value in state.items():
        idx, _, path = key.partition(".")
        mod = children[int(idx)]
        *parents, leaf = path.split(".")
        for p in parents:
            mod = getattr(mod, p)
        if leaf == "needs_scaling":
            if isinstance(mod, Normalize):
                mod.needs_scaling = bool(np.asarray(value))
            elif bool(np.asarray(value)) != bool(mod.needs_scaling):
                raise ValueError("%s: needs_scaling differs from the port's" % key)
            continue
        if leaf == "n_classes" and isinstance(mod, OneHot):
            mod.n_classes = int(np.asarray(value))
            continue
        if leaf not in mod._buffers:
            raise KeyError("%s names no buffer of %s" % (key, type(mod).__name__))
        _set_buffer(mod, leaf, value)
        touched.add(id(mod))
    for child in children:
        if isinstance(child, STFT) and id(child) in touched:
            child._refresh_taps()
    return port_chain


def load_jax_stream_state(
    port_chain: AudioTransform, state: Sequence[Optional[Mapping[str, np.ndarray]]]
) -> List[Optional[Dict[str, torch.Tensor]]]:
    """The port's streaming state for ``port_chain`` from a JAX session's.

    ``state`` holds one entry per child of the chain, as the JAX chain's
    ``init_state`` / ``scan_forward`` return it: a mapping of leaf name to
    array (``input_buffer`` / ``output_buffer`` of OverlapAdd; the carry of a
    ``Realtime*`` transform: nothing, or the RT-PGHI history ``mag_buffer
    (..., 2, F)`` / ``phase_buffer (..., F)`` of a ``pghi`` session, with a
    ``pghi_gl`` session's pinned context ``gl_mag`` / ``gl_phase (...,
    gl_context, F)`` and pending magnitudes ``la_mag (..., lookahead, F)``,
    or a ``sinebank`` session's ``time_index`` (a scalar whatever the batch)
    and ``random_phase (..., 1, F)``) or ``None`` for a stateless child.  A
    ``Realtime*`` entry's keys say its session's mode.  Arrays land on the
    chain's device as float32.  Raises when the number of entries, the keys,
    the trailing (non-batch) shapes or the batch shapes do not match the
    state the port chain allocates itself."""
    children = (
        list(port_chain.transforms)
        if isinstance(port_chain, ComposeAudioTransform)
        else [port_chain]
    )
    if len(state) != len(children):
        raise ValueError("the state has %d entries, the chain %d children" % (len(state), len(children)))
    out: List[Optional[Dict[str, torch.Tensor]]] = []
    for i, (child, entry) in enumerate(zip(children, state)):
        if entry is None:
            if child.init_state(()) is not None:
                raise ValueError("entry %d is None but %s is stateful" % (i, type(child).__name__))
            out.append(None)
            continue
        arrays = {k: np.asarray(v) for k, v in entry.items()}
        mode = None
        if isinstance(child, RealtimeSTFT):
            mode = ("pghi_gl" if "gl_mag" in arrays else "pghi" if "mag_buffer" in arrays
                    else "sinebank" if "time_index" in arrays else "random")
        # the template's shapes only: a generator of its own leaves the
        # chain's draws alone
        template = child.init_state((), mode=mode, generator=torch.Generator(device=child.device))
        if template is None or set(template) != set(arrays):
            raise ValueError(
                "entry %d has keys %s, %s allocates %s"
                % (i, sorted(arrays), type(child).__name__, None if template is None else sorted(template))
            )
        conv, batch = {}, set()
        for k, v in arrays.items():
            t = torch.as_tensor(np.array(v, dtype=np.float32), device=child.device)
            tail = tuple(template[k].shape)
            if t.ndim < len(tail) or tuple(t.shape[t.ndim - len(tail):]) != tail:
                raise ValueError("entry %d.%s: shape %s does not fit the port's (..., %s)"
                                 % (i, k, tuple(t.shape), ", ".join(map(str, tail))))
            if k != "time_index":  # the sinebank's clock is one scalar for the whole batch
                batch.add(tuple(t.shape[: t.ndim - len(tail)]))
            conv[k] = t
        if len(batch) > 1:
            raise ValueError("entry %d: its arrays have the batch shapes %s" % (i, sorted(batch)))
        out.append(conv)
    return out
