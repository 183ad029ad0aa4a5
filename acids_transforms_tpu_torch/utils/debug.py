"""Numerical guards (twin of the JAX ``utils/debug.py``).

The JAX package wraps a function with ``checkify`` so that a NaN or Inf made
anywhere inside surfaces as a Python error with a location.  Here
:func:`checked` runs the function under a dispatch mode that looks at the
floating-point output of every operator as it runs and raises at the first
that holds a NaN or an Inf, naming the operator.  The hand-written kernels are
launched through ``ctypes``, past the dispatcher: their outputs are checked
where the next operator, or the function's return, hands them on.  A
debugging tool: every check reads the result back, which synchronizes the
card after every operator.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["checked", "assert_finite"]

# allocations hand back whatever the memory held: not a result to check
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _nonfinite(t) -> bool:
    return (
        isinstance(t, torch.Tensor)
        and (t.is_floating_point() or t.is_complex())
        and t.device.type != "meta"
        and not bool(torch.isfinite(t).all())
    )


def assert_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Raise ``FloatingPointError`` if ``x`` holds a NaN or an Inf; return
    ``x`` otherwise (a host read of one flag)."""
    if _nonfinite(x):
        raise FloatingPointError("%s contains NaN/Inf" % name)
    return x


class _FiniteMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] not in _UNINITIALIZED:
            with torch.utils._python_dispatch._disable_current_modes():
                if any(_nonfinite(t) for t in pytree.tree_leaves(out)):
                    raise FloatingPointError("%s produced NaN/Inf" % func)
        return out


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that a NaN or Inf raises eagerly::

        fwd = checked(lambda x: chain.forward(x))
        y = fwd(x)   # FloatingPointError naming the operator that made it
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FiniteMode():
            out = fn(*args, **kwargs)
        for i, leaf in enumerate(pytree.tree_leaves(out)):
            assert_finite(leaf, "output leaf %d of %s" % (i, getattr(fn, "__name__", "fn")))
        return out

    return wrapper
