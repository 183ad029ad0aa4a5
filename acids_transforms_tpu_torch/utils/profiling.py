"""Tracing and timing hooks (twin of the JAX ``utils/profiling.py``).

``trace`` wraps ``torch.profiler.profile`` (the CPU, and CUDA where a card is
present) and writes a Chrome trace viewable in Perfetto; ``annotate`` names
pipeline stages in it (and, on a card, as NVTX ranges); ``device_timeit``
times a call in steady state with CUDA events on the card and the host clock
on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["trace", "annotate", "device_timeit"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``log_dir/trace.json`` (Chrome trace
    format); yields the ``torch.profiler.profile`` (``key_averages()``,
    ``events()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named range for the trace: ``with annotate("stft"): ...``."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_timeit(fn: Callable[..., Any], *args, iters: int = 10, repeats: int = 3) -> float:
    """Best-of-``repeats`` seconds a call of ``fn(*args)`` (after one warm
    call), each repeat ``iters`` calls back to back: timed with CUDA events
    when an argument lies on a card, else with the host clock."""
    cuda = [a.device for a in pytree.tree_leaves(args) if isinstance(a, torch.Tensor) and a.is_cuda]
    fn(*args)
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            with torch.cuda.device(cuda[0]):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            best = min(best, (time.perf_counter() - t0) / iters)
    return best
