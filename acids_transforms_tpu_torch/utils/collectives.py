"""The collectives a call issues, for the multi-device no-collective contract
(twin of the JAX ``utils/hlo.py``).

The batch-sharded legs (``parallel.shard_map_batch``: ``fuse_forward(mesh=)``,
the scans and ``StreamingSession(mesh=)``, ``CompiledTransform(mesh=)``)
promise that each rank runs the single-device call on its slice with no
traffic between ranks; the sharded ``fuse_fit`` may add the combine of its
scalar statistics and nothing else.  The JAX package reads that off the
compiled module's text; an eager program has no such text, so
:func:`record_collectives` records the collectives a call really issues: a
dispatch mode sees every ``torch.ops.c10d`` / ``_c10d_functional`` operator
(``dist.all_reduce``, ``dist.batch_isend_irecv``, ``DTensor`` redistributions)
with its tensors, and keeps each op's family and element count.
:func:`collective_violations` then applies the JAX rules to the records.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVE_OPS", "record_collectives", "collective_violations"]

#: the five families of the JAX checker (``collective-permute``'s twin is the
#: point-to-point pair ``send`` / ``recv``); any other collective (broadcast,
#: barrier, ...) is recorded under its own name
COLLECTIVE_OPS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all", "send", "recv")

_FAMILY = (
    ("allgather", "all_gather"),
    ("all_gather", "all_gather"),
    ("allreduce", "all_reduce"),
    ("all_reduce", "all_reduce"),
    ("reduce_scatter", "reduce_scatter"),
    ("alltoall", "all_to_all"),
    ("all_to_all", "all_to_all"),
    ("recv", "recv"),
    ("send", "send"),
)


def _family(name: str) -> str:
    for key, fam in _FAMILY:
        if key in name:
            return fam
    return name


class _Recorder(TorchDispatchMode):
    def __init__(self, records: List[Tuple[str, int]]):
        super().__init__()
        self.records = records

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional", "c10d_functional"):
            name = func._schema.name.split("::")[-1]
            if not name.startswith("wait") and "wrap" not in name:   # completions, autograd wrappers
                sizes = [t.numel() for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
                # the largest tensor the op moves (an all-gather's output
                # included); -1 when none can be read
                self.records.append((_family(name), max(sizes, default=-1)))
        return func(*args, **kwargs)


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Tuple[str, int]]]:
    """``with record_collectives() as recs: ...``: ``recs`` lists one
    ``(family, elements)`` per collective issued inside, in order."""
    records: List[Tuple[str, int]] = []
    with _Recorder(records):
        yield records


def collective_violations(
    records,
    allow_scalar_all_reduce: bool = False,
    scalar_max_elems: int = 64,
) -> List[Tuple[str, int]]:
    """The offending collectives among ``records`` (``(op, elems)`` pairs from
    :func:`record_collectives`), sorted and without repeats.

    With ``allow_scalar_all_reduce`` (the sharded fit's policy), all-reduces
    of at most ``scalar_max_elems`` elements are permitted, the scalar
    statistics combine, while anything batch-shaped still violates.  The
    forward / roundtrip / invert / serving legs take the default policy:
    every collective is a violation.  A size that could not be read (-1)
    always violates."""
    out = set()
    for op, n in records:
        if op == "all_reduce" and allow_scalar_all_reduce and 0 <= n <= scalar_max_elems:
            continue
        out.add((op, int(n)))
    return sorted(out)
