"""Chain fusion: dispatch recognized transform chains to a fused forward / fit
(twin of the JAX ``fuse.py``, melspec and representation patterns).

``fuse_forward(chain)`` inspects a ``ComposeAudioTransform`` and, when the
structure matches one of the patterns

    [Mono?] + (STFT | DGT) + Magnitude                      (melspec)
    [Mono?] + (STFT | DGT) + (Polar | PolarIF | Cartesian)  (representation)
    [Mono?] + MFCC                                          (mfcc)

returns a callable that computes the whole pipeline without materializing the
complex spectrogram.  The MFCC pattern is a power (or magnitude) mel
spectrogram with no contrast and no affine, transposed to MFCC's bin-major
layout, its norm applied after in float32; it declines ``n_mfcc`` (the DCT
runs eagerly only), a power other than 1 or 2, an impl other than the GEMM
DFT and ``hop`` not dividing ``n_fft``.  The representation pattern computes both channels from
one DFT; it declines ``Phase(unwrap=True)`` and an IF stencil other than
``forward`` (both need the whole clip's unwrapped phase) and a front-counted
``stack``.  Any chain that does not match falls back to ``chain.forward``.

Backends:

- ``"kernel"``: the hand-written CUDA kernels (``ops/cuda/spectral.py``):
  DFT + window + mel + contrast + normalizer in one pass (the representation
  pattern: both channels and both normalizers), through the chunk-factored
  front end for a cosine-sum window and the full-K front end for any other
  (the DGT's gaussian).  Needs ``hop | n_fft`` and a non-log contrast
  (``log``/``log10`` amplify the magnitude error without bound near silent
  bins).  On a CPU tensor the same wrapper runs the kernel's plain PyTorch
  version.
- ``"eager"``: the fused-GEMM torch formulation (windowed frames against the
  DFT matrices, then the channels' epilogues on the real/imaginary parts).
- ``"auto"`` (default): per call, the kernel when the input lies on a CUDA
  device, the chain is eligible and its shape lies inside the kernel's
  region measured on the H100 (``regions.py``: per pattern the n_fft range
  and the routes where the kernel won: the FFT route at a power of two, the
  smooth route at an even 5-smooth n_fft, the product or factored front end
  elsewhere), else the eager
  formulation, which was measured faster at the shapes the kernel covers
  outside the region.

``fuse_fit`` is the same story for the *fit* pass: the kernel's statistics
epilogue reduces the normalization statistics (of both channels, for the
representation pattern) without writing the spectrogram; under ``auto`` a
window without taps takes it only inside its family's measured region
(``regions.fit_fullk_region_ok``).

``mesh=`` (a ``DeviceMesh``, ``parallel/mesh.py``) partitions both over the
leading batch axis ``shard_axis``: the forward runs each rank's slice through
the single-device dispatch (kernels included) under
``parallel.shard_map_batch`` and issues no collective; the fit runs the
statistics kernel on each rank's slice and combines the per-shard statistics
with three all-reduces of a few scalars (:func:`_combine_stats`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .ops.cuda.spectral import (
    fused_melspec_available,
    fused_melspec_op,
    fused_melspec_stats,
    fused_repr_stats,
    fused_spectral_repr,
)
from .ops.fft import _resolve_impl, stft_real, taps_for_window
from .ops.windows import hann_window
from .regions import fit_fullk_region_ok, melspec_region_ok, mfcc_region_ok, repr_region_ok
from .transforms.base import AudioTransform, ComposeAudioTransform
from .transforms.dgt import DGT
from .transforms.mel import MFCC
from .transforms.norm import Normalize
from .transforms.raw import Mono
from .transforms.spectral_repr import Cartesian, Magnitude, Polar, PolarIF
from .transforms.stft import STFT

__all__ = ["fuse_forward", "fuse_fit", "fusable", "fit_fusable"]

_BACKENDS = ("auto", "eager", "kernel")


def _from_pcm(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 as ``x / 32768``.  Exact: int16 -> float32 is
    lossless and the power-of-two scale only shifts exponents, so everything
    downstream is bit-identical to feeding the pre-converted float array."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) * 2.0 ** -15
    return x


def _spectral_chain(chain: AudioTransform):
    """``(mono, stft, last)`` of a ``[Mono?] + (STFT | DGT) + last`` chain whose
    DFT is the GEMM formulation, else None.  Realtime subclasses take frames,
    not signals, and never match."""
    if not isinstance(chain, ComposeAudioTransform):
        return None
    ts = list(chain.transforms)
    mono = None
    if ts and type(ts[0]) is Mono:
        mono = ts[0]
        ts = ts[1:]
    if len(ts) != 2 or type(ts[0]) not in (STFT, DGT):
        return None
    if _resolve_impl(ts[0].impl, ts[0].n_fft) != "matmul":
        return None  # the fused formulation is the GEMM DFT
    return mono, ts[0], ts[1]


def _match_melspec(chain: AudioTransform, backend: str = "eager"):
    """Return (mono, stft, magnitude) if the chain matches, else None."""
    parts = _spectral_chain(chain)
    if parts is None or type(parts[2]) is not Magnitude:
        return None
    mono, stft_t, mag_t = parts
    if mag_t.mel and mag_t.n_fft != stft_t.n_fft:
        # mismatched bank: let the chain raise its own matmul shape error
        return None
    if backend == "kernel":
        if not fused_melspec_available(stft_t.n_fft, stft_t.hop_length, stft_t._window_taps):
            return None
        if mag_t.contrast_mode in ("log", "log10"):
            return None
    return mono, stft_t, mag_t


def _match_repr(chain: AudioTransform, backend: str = "eager"):
    """Return ``(mono, stft, rep, second)`` for a fusable representation chain
    ``[Mono?] + (STFT | DGT) + (Polar | PolarIF | Cartesian)``, else None.

    ``second`` selects the kernels' channel 2: ``"phase"`` (Polar, without
    ``unwrap``: unwrapping is a cumulative sum over the clip), ``"if"``
    (PolarIF with the ``forward`` stencil, the only one whose boundary rows
    are frame-local) or ``"imag"`` (Cartesian)."""
    parts = _spectral_chain(chain)
    if parts is None or type(parts[2]) not in (Polar, PolarIF, Cartesian):
        return None
    mono, stft_t, rep = parts
    if rep.stack is not None and not (isinstance(rep.stack, int) and rep.stack < 0):
        return None  # a front-counted stack dimension depends on the batch rank
    if type(rep) is Cartesian:
        second = "imag"
    elif type(rep) is Polar:
        if rep.phase.unwrap:
            return None
        second = "phase"
    else:
        if rep.phase.method != "forward":
            return None
        second = "if"
    if second != "imag":
        mag_t = rep.magnitude
        if mag_t.mel and mag_t.n_fft != stft_t.n_fft:
            return None  # mismatched bank: let the chain raise its own error
        if backend == "kernel" and mag_t.contrast_mode in ("log", "log10"):
            return None
    if backend == "kernel" and not fused_melspec_available(
        stft_t.n_fft, stft_t.hop_length, stft_t._window_taps
    ):
        return None
    return mono, stft_t, rep, second


def fusable(chain: AudioTransform, backend: str = "auto") -> bool:
    be = "eager" if backend == "auto" else backend
    return any(m(chain, be) is not None for m in (_match_mfcc, _match_melspec, _match_repr))


def _from_pcm_for_mono(mono: Mono, x: torch.Tensor) -> torch.Tensor:
    """int16 PCM entering a ``Mono`` stage: mixing/normalizing needs float
    arithmetic, so convert up front; every other Mono config is a
    slice/squeeze, so the PCM dtype survives to the kernel's own convert."""
    if x.dtype == torch.int16 and (
        mono.normalize or (x.ndim >= 2 and x.shape[-2] == 2 and mono.mode == "mix")
    ):
        return _from_pcm(x)
    return x


def _norm_affine(norm):
    """(offset, scale) of a Normalize / Dummy child."""
    if isinstance(norm, Normalize):
        return norm.offset, norm.scale
    return 0.0, 1.0


def _eager_fused(mono: Optional[Mono], stft_t: STFT, mag_t: Magnitude, out_dtype):
    n_fft, hop = stft_t.n_fft, stft_t.hop_length

    def forward(x: torch.Tensor) -> torch.Tensor:
        x = _from_pcm(x)
        if mono is not None:
            x = mono.forward(x)
        re, im = stft_real(
            x, n_fft, hop, stft_t.window, impl=stft_t.impl, taps=stft_t._window_taps
        )
        # the tiny floor keeps the gradient finite at silent bins
        # (d sqrt(0) = inf); its forward impact is ~1e-19
        mag = torch.sqrt(torch.clamp_min(re * re + im * im, torch.finfo(torch.float32).tiny))
        if mag_t.mel:
            mag = torch.matmul(mag, mag_t.mel_bank)
        mag = mag_t.norm.forward(mag_t.contrast(mag))
        return mag_t._drop_nyquist(mag).to(out_dtype)

    return forward


def _kernel_fused(mono: Optional[Mono], stft_t: STFT, mag_t: Magnitude, out_dtype):
    contrast = mag_t.contrast_mode or "none"
    eager_forward = _eager_fused(mono, stft_t, mag_t, out_dtype)

    def kernel_forward(x: torch.Tensor) -> torch.Tensor:
        if mono is not None:
            x = mono.forward(_from_pcm_for_mono(mono, x))
        batch_shape = x.shape[:-1]
        offset, scale = _norm_affine(mag_t.norm)
        y = fused_melspec_op(
            x.reshape((-1, x.shape[-1])),
            stft_t.n_fft,
            stft_t.hop_length,
            mag_t.mel_bank if mag_t.mel else None,
            offset,
            scale,
            contrast,
            taps=stft_t._window_taps,
            out_dtype=out_dtype,
            window=stft_t.window,
        )
        return mag_t._drop_nyquist(y.reshape(batch_shape + y.shape[1:]))

    return _with_eager_gradient(kernel_forward, eager_forward)


def _with_eager_gradient(kernel_forward, eager_forward):
    """The kernels have no backward kernel: a fused forward's value (a tensor
    or a tuple of them) is paired with the gradient of the mathematically
    identical eager formulation."""

    class _Fused(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return kernel_forward(x)

        @staticmethod
        def backward(ctx, *grads):
            (x,) = ctx.saved_tensors
            with torch.enable_grad():
                xin = x.detach().requires_grad_(True)
                y = eager_forward(xin)
            (gx,) = torch.autograd.grad(y, xin, grads if isinstance(y, tuple) else grads[0])
            return gx

    def forward(x: torch.Tensor):
        if x.requires_grad:
            return _Fused.apply(x)
        return kernel_forward(x)

    return forward


def _match_mfcc(chain: AudioTransform, backend: str = "eager"):
    """``(mono, mfcc)`` of a ``[Mono?] + MFCC`` chain (or a bare MFCC) whose
    forward is a power or magnitude mel spectrogram, else None.  With
    ``backend="kernel"`` also the shapes kernel A takes."""
    mono = None
    if isinstance(chain, ComposeAudioTransform):
        ts = list(chain.transforms)
        if ts and type(ts[0]) is Mono:
            mono = ts[0]
            ts = ts[1:]
        if len(ts) != 1:
            return None
        chain = ts[0]
    if type(chain) is not MFCC:
        return None
    if chain.n_mfcc or chain.power not in (1.0, 2.0):
        return None
    if _resolve_impl(chain.impl, chain.n_fft) != "matmul" or chain.n_fft % chain.hop_length != 0:
        return None
    if backend == "kernel" and not fused_melspec_available(chain.n_fft, chain.hop_length, _mfcc_taps(chain)):
        return None
    return mono, chain


def _mfcc_taps(mfcc: MFCC):
    """The taps of MFCC's hann window, read off a float64 hann rather than
    off the float32 buffer, so that they are exact."""
    return taps_for_window(hann_window(mfcc.n_fft, dtype=torch.float64))


def _mfcc_epilogue(mfcc: MFCC, mel: torch.Tensor, out_dtype) -> torch.Tensor:
    """Bin-major layout, the norm in float32, the cast last."""
    mel = mel.transpose(-2, -1)
    if mfcc.norm is not None:
        mel = mfcc.norm.forward(mel)
    return mel.to(out_dtype)


def _eager_fused_mfcc(mono: Optional[Mono], mfcc: MFCC, out_dtype):
    taps = _mfcc_taps(mfcc)

    def forward(x: torch.Tensor) -> torch.Tensor:
        mfcc._check(x)
        if mono is not None:
            x = mono.forward(_from_pcm_for_mono(mono, x))
        re, im = stft_real(_from_pcm(x), mfcc.n_fft, mfcc.hop_length, mfcc.window, impl=mfcc.impl, taps=taps)
        p = re * re + im * im
        if mfcc.power != 2.0:
            # the tiny floor keeps the gradient finite at silent bins
            p = torch.sqrt(torch.clamp_min(p, torch.finfo(torch.float32).tiny))
        return _mfcc_epilogue(mfcc, torch.matmul(p, mfcc.mel_bank), out_dtype)

    return forward


def _kernel_fused_mfcc(mono: Optional[Mono], mfcc: MFCC, out_dtype):
    """Kernel A with MFCC's taps, its rectangular bank, offset 0, scale 1, no
    contrast and ``power``; float32 out, then the epilogue."""
    taps = _mfcc_taps(mfcc)
    eager_forward = _eager_fused_mfcc(mono, mfcc, out_dtype)

    def kernel_forward(x: torch.Tensor) -> torch.Tensor:
        mfcc._check(x)
        if mono is not None:
            x = mono.forward(_from_pcm_for_mono(mono, x))
        batch_shape = x.shape[:-1]
        mel = fused_melspec_op(
            x.reshape((-1, x.shape[-1])), mfcc.n_fft, mfcc.hop_length, mfcc.mel_bank, 0.0, 1.0,
            "none", taps=taps, power=mfcc.power, window=mfcc.window,
        )
        return _mfcc_epilogue(mfcc, mel.reshape(batch_shape + mel.shape[1:]), out_dtype)

    return _with_eager_gradient(kernel_forward, eager_forward)


def _stack_repr(rep, y1, y2):
    if rep.stack is None:
        return y1, y2
    return torch.stack([y1, y2], dim=rep.stack)


def _repr_config(rep, second):
    """(contrast, mel bank or None, weighted) the representation kernels take."""
    if second == "imag":
        return "none", None, False
    mag_t = rep.magnitude
    return (mag_t.contrast_mode or "none", mag_t.mel_bank if mag_t.mel else None,
            bool(getattr(rep.phase, "weighted", False)))


def _eager_fused_repr(mono, stft_t: STFT, rep, second: str, out_dtype):
    """Both channels from one real/imaginary STFT pass, through the
    transforms' own channel code (the complex spectrogram of
    ``chain.forward`` is never formed)."""
    n_fft, hop = stft_t.n_fft, stft_t.hop_length

    def forward(x: torch.Tensor):
        x = _from_pcm(x)
        if mono is not None:
            x = mono.forward(x)
        re, im = stft_real(x, n_fft, hop, stft_t.window, impl=stft_t.impl, taps=stft_t._window_taps)
        if second == "imag":
            y1 = rep.magnitude._drop_nyquist(rep.magnitude.norm.forward(re))
            y2 = rep.phase._drop_nyquist(rep.phase.norm.forward(im))
        else:
            mag_t = rep.magnitude
            mag = torch.sqrt(torch.clamp_min(re * re + im * im, torch.finfo(torch.float32).tiny))
            if mag_t.mel:
                mag = torch.matmul(mag, mag_t.mel_bank)
            y1 = mag_t._drop_nyquist(mag_t.norm.forward(mag_t.contrast(mag)))
            ph = torch.atan2(im, re)
            y2 = ph if second == "phase" else rep.phase.get_if_from_phase(ph)
            y2 = rep.phase._drop_nyquist(rep.phase.norm.forward(y2))
        return _stack_repr(rep, y1.to(out_dtype), y2.to(out_dtype))

    return forward


def _kernel_fused_repr(mono, stft_t: STFT, rep, second: str, out_dtype):
    contrast, mel_bank, weighted = _repr_config(rep, second)
    eager_forward = _eager_fused_repr(mono, stft_t, rep, second, out_dtype)

    def kernel_forward(x: torch.Tensor):
        if mono is not None:
            x = mono.forward(_from_pcm_for_mono(mono, x))
        batch_shape = x.shape[:-1]
        o1, s1 = _norm_affine(rep.magnitude.norm)
        o2, s2 = _norm_affine(rep.phase.norm)
        y1, y2 = fused_spectral_repr(
            x.reshape((-1, x.shape[-1])), stft_t.n_fft, stft_t.hop_length, second,
            mel_bank=mel_bank, aff=(o1, s1, o2, s2), contrast=contrast, weighted=weighted,
            taps=stft_t._window_taps, window=stft_t.window,
        )
        y1 = rep.magnitude._drop_nyquist(y1.reshape(batch_shape + y1.shape[1:]))
        y2 = rep.phase._drop_nyquist(y2.reshape(batch_shape + y2.shape[1:]))
        return _stack_repr(rep, y1.to(out_dtype), y2.to(out_dtype))

    return _with_eager_gradient(kernel_forward, eager_forward)


def _melspec_region(stft_t) -> bool:
    return melspec_region_ok(stft_t.n_fft, stft_t.hop_length, stft_t._window_taps is not None)


def _repr_region(rmatch) -> bool:
    stft_t, second = rmatch[1], rmatch[3]
    return repr_region_ok(stft_t.n_fft, stft_t.hop_length, stft_t._window_taps is not None, second)


def _kernel_preferred(chain: AudioTransform) -> bool:
    """The ``auto`` decision for a CUDA input, as data: a kernel covers the
    chain and its shape lies inside the kernel's measured region."""
    m = _match_mfcc(chain, "kernel")
    if m is not None:
        return mfcc_region_ok(m[1].n_fft, m[1].hop_length)
    m = _match_melspec(chain, "kernel")
    if m is not None:
        return _melspec_region(m[1])
    m = _match_repr(chain, "kernel")
    return m is not None and _repr_region(m)


def _fit_region(stft_t, two_channel: bool = False) -> bool:
    """A window with taps fits on the kernel wherever it is available, one
    without inside its family's measured region (F's, or with
    ``two_channel`` H full-K's: each region lists the routes its kernel won
    on, measured apart)."""
    return stft_t._window_taps is not None or fit_fullk_region_ok(stft_t.n_fft, two_channel)


def fuse_forward(
    chain: AudioTransform,
    backend: str = "auto",
    out_dtype: torch.dtype = torch.float32,
    mesh=None,
    shard_axis: str = "data",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return the fused forward for ``chain`` (see module docs).

    ``out_dtype`` (float32 or bfloat16) is the dtype of the returned
    features: all arithmetic stays float32 and only the final store rounds,
    exactly ``forward(x).to(torch.bfloat16)`` (the MFCC pattern stores
    float32 from the kernel and casts after its transpose and norm).  Matched chains also accept
    **int16 PCM** input, read as ``x / 32768``: bit-identical to
    pre-converting.  An explicit ``backend="kernel"`` on a chain the kernel
    does not cover raises; it takes the kernel outside the measured region
    too.

    ``mesh=``: the returned forward runs under
    ``parallel.shard_map_batch`` over ``shard_axis``: each rank calls the
    single-device dispatch on its local batch slice (``(B, 1, L)`` for a
    chain with ``Mono``; ``B`` divisible by the axis size) and the output is
    a ``DTensor`` sharded on its batch axis, with no collective.
    """
    if backend not in _BACKENDS:
        raise ValueError("unknown fuse backend %r" % backend)
    if mesh is not None:
        from .parallel.sharding import shard_map_batch

        return shard_map_batch(fuse_forward(chain, backend=backend, out_dtype=out_dtype), mesh, shard_axis)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("fuse_forward: out_dtype must be float32 or bfloat16, got %s" % out_dtype)
    mmatch = _match_mfcc(chain, "eager")
    match = _match_melspec(chain, "eager") if mmatch is None else None
    rmatch = _match_repr(chain, "eager") if mmatch is None and match is None else None
    if backend == "kernel":
        if mmatch is not None:
            kmatch = _match_mfcc(chain, "kernel")
            if kmatch is None:
                raise ValueError(
                    "backend='kernel' requested but kernel A does not cover this MFCC "
                    "(needs hop | n_fft with 2 <= n_fft / hop <= 8 and hop a multiple of 32); "
                    "use backend='auto' to fall back"
                )
            return _kernel_fused_mfcc(*kmatch, out_dtype)
        kmatch = _match_melspec(chain, "kernel")
        if kmatch is not None:
            return _kernel_fused(*kmatch, out_dtype)
        kmatch = _match_repr(chain, "kernel")
        if kmatch is None:
            raise ValueError(
                "backend='kernel' requested but no fused kernel covers this "
                "chain (needs a [Mono?] + (STFT | DGT) + (Magnitude | Polar | "
                "PolarIF | Cartesian) pattern with hop | n_fft, a non-log "
                "contrast and a shape inside fused_melspec_available); use "
                "backend='auto' to fall back"
            )
        return _kernel_fused_repr(*kmatch, out_dtype)
    if mmatch is not None:
        eager = _eager_fused_mfcc(*mmatch, out_dtype)
    elif match is not None:
        eager = _eager_fused(*match, out_dtype)
    elif rmatch is not None:
        eager = _eager_fused_repr(*rmatch, out_dtype)
    elif out_dtype == torch.float32:
        return chain.forward
    else:
        def _cast_fallback(x):
            y = chain.forward(x)
            if y.is_complex():
                raise ValueError(
                    "fuse_forward(out_dtype=%s): chain produces complex output; "
                    "cast a real representation instead" % out_dtype
                )
            return y.to(out_dtype)

        return _cast_fallback
    if backend == "eager" or not _kernel_preferred(chain):
        return eager
    kernel = fuse_forward(chain, backend="kernel", out_dtype=out_dtype)

    def auto_forward(x: torch.Tensor):
        return kernel(x) if x.is_cuda else eager(x)

    return auto_forward


def _match_fit(chain: AudioTransform):
    """Like :func:`_match_melspec` for the *fit* pass.  Fit statistics are
    taken on the non-mel contrasted magnitude, so the mel / keep_nyquist
    options do not matter, only the framing and the contrast do.  A window
    without cosine-sum taps takes the full-K statistics kernel at every size
    the kernel can hold; beyond that a CUDA tensor raises."""
    return _match_melspec(chain, backend="kernel")


def _norm_from_stats(norm: Normalize, st: dict) -> Normalize:
    """Fitted copy of a :class:`Normalize` from kernel-reduced statistics
    (``st``: sum/sumsq/min/max scalars and the exact integer ``count``),
    matching ``Normalize.fit``."""
    if norm.mode == "unipolar":
        offset = st["min"]
        scale = st["max"] - st["min"]
    elif norm.mode == "bipolar":
        offset = (st["max"] + st["min"]) / 2.0
        scale = st["max"] - offset
    else:  # gaussian, in float64: sumsq - n mean^2 cancels badly in float32
        n = float(st["count"])
        s, ss = st["sum"].double(), st["sumsq"].double()
        offset = s / n
        var = torch.clamp_min(ss - n * offset * offset, 0.0)
        scale = torch.clamp_min(torch.sqrt(var / max(n - 1.0, 1.0)), 1e-12)
    return norm.with_stats(offset, scale)


def _fittable(norm) -> bool:
    return isinstance(norm, Normalize) and norm.mode is not None


def fit_fusable(chain: AudioTransform) -> bool:
    return _match_fit(chain) is not None or _match_repr(chain, "kernel") is not None


def _combine_stats(st: dict, mesh, axis_name: str) -> dict:
    """Cross-shard combine of a statistics tree (``sum`` / ``sumsq`` / ``min``
    / ``max`` per channel, ``count``): the sums in one all-reduce SUM in the
    dtype the kernel reduced them in (float64, so that a world of one is the
    identity and the order of the ranks' float32 partials does not matter),
    the extrema in one MIN and one MAX (exact), and ``count`` an exact Python
    int times the axis size (every shard holds the same number of
    elements)."""
    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    parts = {"sum": [], "min": [], "max": []}

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k != "count":
                parts["max" if k == "max" else "min" if k == "min" else "sum"].append((path + (k,), v))

    walk(st, ())
    out: dict = {"count": st["count"] * n} if "count" in st else {}
    for kind, op in (("sum", dist.ReduceOp.SUM), ("min", dist.ReduceOp.MIN), ("max", dist.ReduceOp.MAX)):
        if not parts[kind]:
            continue
        dtype = parts[kind][0][1].dtype
        buf = torch.stack([v.to(dtype) for _, v in parts[kind]])
        dist.all_reduce(buf, op=op, group=group)
        for i, (path, v) in enumerate(parts[kind]):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = buf[i].to(v.dtype)
    return out


def _stats_over(stats_fn, x: torch.Tensor, mesh, axis_name: str) -> dict:
    """``stats_fn`` of ``x``, or with a mesh of each rank's batch slice,
    combined over the ranks."""
    if mesh is None:
        return stats_fn(x)
    from .parallel.sharding import local_batch

    return _combine_stats(stats_fn(local_batch(x, mesh, axis_name, "fuse_fit(mesh=)")), mesh, axis_name)


def fuse_fit(
    chain: AudioTransform, backend: str = "auto", mesh=None, shard_axis: str = "data"
) -> Callable[..., AudioTransform]:
    """Return a one-pass ``fit`` for a melspec or representation chain.

    The returned callable maps raw audio to a fitted copy of ``chain`` like
    ``chain.fit(x)``, but the normalization statistics are reduced inside the
    fused kernel (``ops/cuda/spectral.py:fused_melspec_stats``, or
    ``fused_repr_stats`` for both channels of a representation): neither the
    framed signal nor the spectrogram is ever written out.  Matched chains
    accept int16 PCM input.  ``backend="auto"`` takes the kernel for a CUDA
    input on an eligible chain inside its region (:func:`_fit_region`) and
    ``chain.fit`` otherwise;
    ``backend="kernel"`` forces the statistics path (its plain PyTorch version
    on a CPU tensor) and raises on a chain it does not cover.  A ``mask``
    always takes the exact cascade.

    ``mesh=``: each rank runs the statistics kernel on its slice of the
    leading batch axis ``shard_axis`` and only the per-shard scalars cross
    ranks (:func:`_combine_stats`); the audio batch is never gathered.  Every
    rank returns the same fitted chain.  The paths without the kernel (a
    mask, ``auto`` on a CPU tensor, an unmatched chain) fit the whole batch
    on every rank (a ``DTensor`` input is gathered for them).
    """
    if backend not in ("auto", "kernel"):
        raise ValueError("unknown fuse_fit backend %r" % backend)
    match = _match_fit(chain)
    # the representation fit takes the kernel's gate, as _match_fit does: the
    # channel-1 statistics are of the contrasted magnitude
    rmatch = _match_repr(chain, "kernel") if match is None else None
    if rmatch is not None:
        return _fuse_fit_repr(chain, backend, mesh, shard_axis, *rmatch)
    if match is None:
        if backend == "kernel":
            raise ValueError(
                "backend='kernel' requested but the fused fit does not cover "
                "this chain (see fuse_forward); use backend='auto'"
            )
        return _whole_fit(chain, mesh)
    mono, stft_t, mag_t = match
    norm = mag_t.norm
    if not _fittable(norm):
        return _whole_fit(chain, mesh)  # nothing to fit on this pattern

    eager = backend == "auto" and not _fit_region(stft_t)

    def stats(xl: torch.Tensor) -> dict:
        y = mono.forward(_from_pcm_for_mono(mono, xl)) if mono is not None else xl
        return fused_melspec_stats(
            y.reshape((-1, y.shape[-1])),
            stft_t.n_fft,
            stft_t.hop_length,
            mag_t.contrast_mode or "none",
            taps=stft_t._window_taps,
            window=stft_t.window,
        )

    def fit(x: torch.Tensor, mask=None) -> AudioTransform:
        if mask is not None or (backend == "auto" and not x.is_cuda) or eager:
            return chain.fit(_from_pcm(_whole(x)), mask=mask)
        st = _stats_over(stats, x, mesh, shard_axis)
        new_mag = mag_t.replace(norm=_norm_from_stats(norm, st))
        # Mono/STFT fits are no-ops in the matched pattern; only the
        # Magnitude's norm carries fitted state.
        children = [new_mag if t is mag_t else t for t in chain.transforms]
        return ComposeAudioTransform(transforms=children, sr=chain.sr, device=chain.device)

    return fit


def _whole(x):
    """``x``, or the whole of a ``DTensor`` input (an all-gather)."""
    if type(x) is torch.Tensor:
        return x
    from .parallel.sharding import whole

    return whole(x)


def _whole_fit(chain: AudioTransform, mesh):
    """``chain.fit``; with a mesh on the whole batch (a ``DTensor`` input
    gathered first)."""
    if mesh is None:
        return chain.fit
    return lambda x, mask=None: chain.fit(_whole(x), mask=mask)


def _fuse_fit_repr(chain, backend, mesh, shard_axis, mono, stft_t, rep, second):
    """The representation pattern's one-pass fit: both channels' statistics
    from one kernel launch (``fused_repr_stats``); a ``Dummy`` channel keeps
    its identity norm."""
    if not (_fittable(rep.magnitude.norm) or _fittable(rep.phase.norm)):
        return _whole_fit(chain, mesh)  # both channels unnormalized: nothing to fit
    contrast, _, weighted = _repr_config(rep, second)
    eager = backend == "auto" and not _fit_region(stft_t, two_channel=True)

    def stats(xl: torch.Tensor) -> dict:
        y = mono.forward(_from_pcm_for_mono(mono, xl)) if mono is not None else xl
        return fused_repr_stats(
            y.reshape((-1, y.shape[-1])), stft_t.n_fft, stft_t.hop_length, second,
            contrast=contrast, weighted=weighted, taps=stft_t._window_taps, window=stft_t.window,
        )

    def fit(x: torch.Tensor, mask=None) -> AudioTransform:
        if mask is not None or (backend == "auto" and not x.is_cuda) or eager:
            return chain.fit(_from_pcm(_whole(x)), mask=mask)
        st = _stats_over(stats, x, mesh, shard_axis)
        new_mag, new_ph = rep.magnitude, rep.phase
        if _fittable(new_mag.norm):
            new_mag = new_mag.replace(norm=_norm_from_stats(new_mag.norm, {**st["ch1"], "count": st["count"]}))
        if _fittable(new_ph.norm):
            new_ph = new_ph.replace(norm=_norm_from_stats(new_ph.norm, {**st["ch2"], "count": st["count"]}))
        new_rep = rep.replace(magnitude=new_mag, phase=new_ph)
        children = [new_rep if t is rep else t for t in chain.transforms]
        return ComposeAudioTransform(transforms=children, sr=chain.sr, device=chain.device)

    return fit
