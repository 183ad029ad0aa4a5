"""Build and load the package's CUDA kernels at first use.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``acids_transforms_tpu_torch/_build/<hash>/``, keyed by a
hash of the sources and the flags, so a changed source rebuilds and an
unchanged one is reused.  Each ``.cu`` file is its own ``nvcc`` process, all
started together.  A build failure raises with the compiler's output; the
output of a build that succeeds (``-Xptxas -v``: each kernel's registers and
spills) is kept beside the library as ``build.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["load_library", "build_seconds", "build_log", "kernel_resources", "check", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_dir: Optional[Path] = None
_build_seconds: Optional[float] = None
_build_log: str = ""


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of acids_transforms_tpu_torch are built from source at first use"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every ``.cu`` in parallel, link, return the library path."""
    global _build_log
    nvcc = _find_nvcc()
    cu, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append(
            (cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        )
    logs, failed = [], False
    for cmd, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append("$ %s\n%s" % (" ".join(cmd), out))
        failed = failed or proc.returncode != 0
    _build_log = "\n".join(logs)
    if failed:
        raise RuntimeError("nvcc failed:\n" + _build_log)
    lib = out_dir / "libatt_kernels.so"
    tmp = out_dir / ("libatt_kernels.%d.tmp.so" % os.getpid())
    cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _c, o, _p in procs]]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build_log += "\n$ %s\n%s" % (" ".join(cmd), res.stdout)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + _build_log)
    (out_dir / "build.log").write_text(_build_log)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.att_error_string.argtypes = [i]
    lib.att_error_string.restype = ctypes.c_char_p
    lib.att_melspec_smem_bytes.argtypes = [i, i, i, i]
    lib.att_melspec_smem_bytes.restype = ll
    lib.att_melspec_fft_smem_bytes.argtypes = [i, i, i, i, i]
    lib.att_melspec_fft_smem_bytes.restype = ll
    lib.att_melspec_forward.argtypes = [
        p, i, ll, i, i,                  # x_rows, x_int16, B, n_tiles, tile_t
        i, i, i, i, i,                   # n_rows_total, hop, overlap, F, T
        p, p, p, p,                      # bcos, bsin, twr, twi
        ctypes.POINTER(f), i, i, i,      # taps, P, power2, contrast
        p, p, p, i,                      # mel_bank, mel_lo, mel_hi, M
        p, p, i,                         # aff, out, out_bf16
        p, p, i, p,                      # window, fft_tw, fft_teams, stream
    ]
    lib.att_melspec_forward.restype = i
    lib.att_melspec_stats.argtypes = [
        p, i, ll, i, i,
        i, i, i, i, i,
        p, p, p, p,
        ctypes.POINTER(f), i, i,         # taps, P, contrast
        p, p,                            # partials, stats
        p, p, i, p,                      # window, fft_tw, fft_teams, stream
    ]
    lib.att_melspec_stats.restype = i
    lib.att_melspec_stage.argtypes = [
        i, p, ll, i, i,                  # stage, x_rows, B, n_tiles, tile_t
        i, i, i, i, i,                   # n_rows_total, hop, overlap, F, T
        p, p, p, p,                      # bcos, bsin, twr, twi
        ctypes.POINTER(f), i,            # taps, P
        p, p, p, i,                      # mel_bank, mel_lo, mel_hi, M
        p, p, p,                         # aff, out, stream
    ]
    lib.att_melspec_stage.restype = i
    lib.att_repr_smem_bytes.argtypes = [i, i, i, i, i]
    lib.att_repr_smem_bytes.restype = ll
    lib.att_repr.argtypes = [
        i, p, i, ll, i, i,               # stats, x_rows, x_int16, B, n_tiles, tile_t
        i, i, i, i, i,                   # n_rows_total, hop, overlap, F, T
        p, p, p, p,                      # bcos, bsin, twr, twi
        ctypes.POINTER(f), i, i, i, i,   # taps, P, second, weighted, contrast
        p, p, p, p,                      # mel_bank, mel_lo, mel_hi, aff
        p, p, p, p,                      # out1, out2, partials, stats
        p, p, i, p,                      # window, fft_tw, fft_teams, stream
    ]
    lib.att_repr.restype = i
    lib.att_repr_fft_smem_bytes.argtypes = [i, i, i, i, i, i, i, i]
    lib.att_repr_fft_smem_bytes.restype = ll
    lib.att_gl_smem_bytes.argtypes = [i, i, i, i]
    lib.att_gl_smem_bytes.restype = ll
    lib.att_gl_step.argtypes = [
        p, p, p, p, p, p,                # mag, are, aim, tre, tim, env
        ll, i, i, i, i,                  # B, T, F, hop, overlap
        p, p, p, p, p, p,                # bcos, bsin, ict, ist, twr, twi
        ctypes.POINTER(f), i, f, i, i,   # taps, P, mom, chain, tile_t
        p, p, p, p, p, p,                # nare, naim, rre, rim, scratch, stream
    ]
    lib.att_gl_step.restype = i
    lib.att_gl_project.argtypes = [
        p, p, p, p,                      # mag, are, aim, env
        ll, i, i, i, i,                  # B, T, F, hop, overlap
        p, p, p, p, p, p,                # bcos, bsin, ict, ist, twr, twi
        ctypes.POINTER(f), i, i,         # taps, P, tile_t
        p, p, p,                         # rre, rim, stream
    ]
    lib.att_gl_project.restype = i
    lib.att_gl_fft_smem_bytes.argtypes = [i, i, i, i]
    lib.att_gl_fft_smem_bytes.restype = ll
    lib.att_gl_step_fft.argtypes = [
        p, p, p, p, p, p,                # mag, are, aim, tre, tim (or None), env
        p, p, p, p,                      # window, wsyn, leak, fft_tw
        ll, i, i, i, i,                  # B, T, F, hop, overlap
        i, i, f, i, i,                   # tile_t, teams, mom, chain, project
        p, p, p, p, p, p, p,             # nare, naim (or None), rre, rim, scratch, barrier (or None), stream
    ]
    lib.att_gl_step_fft.restype = i
    lib.att_gl_fullk_smem_bytes.argtypes = [i, i, i, i]
    lib.att_gl_fullk_smem_bytes.restype = ll
    lib.att_gl_fullk_fft_smem_bytes.argtypes = [i, i, i, i]
    lib.att_gl_fullk_fft_smem_bytes.restype = ll
    lib.att_gl_fullk_step.argtypes = [
        p, p, p, p, p, p,                # mag, are, aim, tre, tim, env
        p, p, p,                         # syn, wc, ws (or None)
        p, p, p,                         # window, wsyn, fft_tw (or None)
        ll, i, i, i, i, i,               # B, T, F, hop, overlap, Kp
        i, i, i, i, f,                   # rows, tile_t, slab, teams (0: the product route), mom
        p, p, p, p, p,                   # nare, naim, rre, rim, stream
    ]
    lib.att_gl_fullk_step.restype = i
    lib.att_pghi_synth_smem_bytes.argtypes = [i, i, i]
    lib.att_pghi_synth_smem_bytes.restype = ll
    lib.att_pghi_plan_smem_bytes.argtypes = [i, i]
    lib.att_pghi_plan_smem_bytes.restype = ll
    lib.att_pghi_walk_smem_bytes.argtypes = [i, i]
    lib.att_pghi_walk_smem_bytes.restype = ll
    lib.att_pghi_plan.argtypes = [
        p, p, p, p, p,                   # mag, angles, abstol, src, off
        ll, i, i, f, f, f, i, i, p,      # B, T, F, fmul, 1 / fmul, carrier, bidir, tile, stream
    ]
    lib.att_pghi_plan.restype = i
    lib.att_pghi_walk.argtypes = [
        p, p, p,                         # src, off, phases
        ll, i, i, i, i, i, p,            # B, T, F, bidir, chain warps, ring slots, stream
    ]
    lib.att_pghi_walk.restype = i
    lib.att_pghi_phases.argtypes = [
        p, p, p, p, p, p,                # mag, angles, abstol, phases, src, off
        ll, i, i, f, f, f, i,            # B, T, F, fmul, 1 / fmul, carrier, bidir
        i, i, i, p,                      # tile, chain warps, ring slots, stream
    ]
    lib.att_pghi_phases.restype = i
    lib.att_rt_pghi_smem_bytes.argtypes = [i, i]
    lib.att_rt_pghi_smem_bytes.restype = ll
    lib.att_rt_pghi_phases.argtypes = [
        p, p, p, p, p,                   # mag, angles, prev_mag, prev_phase (or None), phases
        ll, i, i, i, i,                  # B, T, Ta, F, T_c
        f, f, f, f,                      # tol, fmul, 1 / fmul, carrier
        i, i, i, p,                      # stage, producer and chain warps, stream
    ]
    lib.att_rt_pghi_phases.restype = i
    lib.att_pghi_synthesize.argtypes = [
        p, p, p, p,                      # mag, phases, basis, out
        ll, i, i, i, i, i, i, p,         # B, T, F, hop, overlap, Kp, rows, stream
    ]
    lib.att_pghi_synthesize.restype = i
    lib.att_pghi_synth_fft_smem_bytes.argtypes = [i, i, i, i]
    lib.att_pghi_synth_fft_smem_bytes.restype = ll
    lib.att_pghi_synthesize_fft.argtypes = [
        p, p, p, p, p,                   # mag, phases, wsyn, fft_tw, out
        ll, i, i, i, i, i, i, p,         # B, T, F, hop, overlap, rows, teams, stream
    ]
    lib.att_pghi_synthesize_fft.restype = i
    lib.att_session_encode_smem_bytes.argtypes = [i, i, i]
    lib.att_session_encode_smem_bytes.restype = ll
    lib.att_session_encode_fft_smem_bytes.argtypes = [i, i, i, i]
    lib.att_session_encode_fft_smem_bytes.restype = ll
    lib.att_session_roundtrip_smem_bytes.argtypes = [i, i, i, i, i]
    lib.att_session_roundtrip_smem_bytes.restype = ll
    lib.att_session_roundtrip_fft_smem_bytes.argtypes = [i, i, i, i]
    lib.att_session_roundtrip_fft_smem_bytes.restype = ll
    lib.att_session_decode_smem_bytes.argtypes = [i, i, i]
    lib.att_session_decode_smem_bytes.restype = ll
    lib.att_session_decode_fft_smem_bytes.argtypes = [i, i, i, i]
    lib.att_session_decode_fft_smem_bytes.restype = ll
    lib.att_session_encode.argtypes = [
        p, p, p, p, p, p,                # x, wc, ws (or None), window, fft_tw (or None), out
        ll, ll, i, i, i, i, i, i,        # B, L, T, F, hop, overlap, Kn, rows
        i, i, p,                         # teams (0: the product route), magnitude, stream
    ]
    lib.att_session_encode.restype = i
    lib.att_session_roundtrip.argtypes = [
        p, p, p, p, p,                   # x, angles (or None), wc, ws, syn (or None)
        p, p, p, p,                      # window, wsyn, fft_tw (or None), out
        ll, ll, i, i, i, i, i, i, i, i,  # B, L, T, Ta, F, hop, overlap, Kn, Kp, rows
        i, p,                            # teams (0: the product route), stream
    ]
    lib.att_session_roundtrip.restype = i
    lib.att_session_decode.argtypes = [
        p, p, p, p, p, p,                # mag (or spectrum), angles (or None), syn, wsyn, fft_tw (or None), out
        ll, i, i, i, i, i, i, i,         # B, T, Ta, F, hop, overlap, Kp, rows
        i, p,                            # teams (0: the product route), stream
    ]
    lib.att_session_decode.restype = i
    lib.att_gl_project_analysis.argtypes = [
        p, p, p, p,                      # y, wc, ws, phase
        ll, ll, i, i, i, i, i,           # B, Ly, Tp, Tx, f0, keep_lo, keep_hi
        i, i, i, p,                      # F, hop, Kn, stream
    ]
    lib.att_gl_project_analysis.restype = i
    lib.att_gl_project_analysis_fft.argtypes = [
        p, p, p, p,                      # y, window, fft_tw, phase
        ll, ll, i, i, i, i, i,           # B, Ly, Tp, Tx, f0, keep_lo, keep_hi
        i, i, i, i, i, p,                # F, hop, overlap, rows, teams, stream
    ]
    lib.att_gl_project_analysis_fft.restype = i
    lib.att_gl_polish_smem_bytes.argtypes = [i, i, i, i, i]
    lib.att_gl_polish_smem_bytes.restype = ll
    lib.att_gl_polish.argtypes = [
        p, p, p, p, p,                   # mag, phase, window, wsyn, fft_tw
        ll, i, i, i, i, i,               # B, Tp, Tx, ctx, keep_lo, keep_hi
        i, i, i, i, i, i, p,             # F, hop, overlap, iters, teams, resident, stream
    ]
    lib.att_gl_polish.restype = i


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call.

    Raises under a fake-tensor trace (a shape probe, ``torch.export``): a
    fake tensor's data pointer is 0, so no kernel may be launched there."""
    global _lib, _lib_dir, _build_seconds
    from ..._device import under_fake_tensors

    if under_fake_tensors():
        raise RuntimeError("no kernel launch under a fake-tensor trace (shapes only)")
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            out_dir = BUILD_ROOT / _source_hash()
            lib_path = out_dir / "libatt_kernels.so"
            if not lib_path.exists():
                lib_path = _build(out_dir)
            lib = ctypes.CDLL(str(lib_path))
            _declare(lib)
            _lib, _lib_dir = lib, out_dir
            _build_seconds = time.perf_counter() - t0
        return _lib


def build_seconds() -> Optional[float]:
    """Seconds the first :func:`load_library` took (build included), or None."""
    return _build_seconds


def build_log() -> str:
    """The compiler's output of the loaded library's build (``build.log``
    beside it when this process reused it; empty before the first load)."""
    if not _build_log and _lib_dir is not None and (_lib_dir / "build.log").exists():
        return (_lib_dir / "build.log").read_text()
    return _build_log


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def kernel_resources(log: Optional[str] = None) -> Dict[str, Dict[str, int]]:
    """Per kernel (by its mangled name) what ``-Xptxas -v`` reported in the
    build log: ``registers`` a thread and ``spill_stores`` / ``spill_loads``
    in bytes."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in (build_log() if log is None else log).splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = _SPILL.search(line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = _REGS.search(line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def check(code: int, what: str) -> None:
    """Raise when a kernel entry returned a CUDA error code."""
    if code != 0:
        msg = load_library().att_error_string(code)
        raise RuntimeError(
            "%s: CUDA error %d (%s)" % (what, code, msg.decode() if msg else "?")
        )


def taps_array(taps):
    """``(c_float * 5, P)`` for a taps tuple."""
    P = len(taps) - 1
    if P > 4:
        raise ValueError("at most 5 taps (P <= 4) are supported, got %d" % len(taps))
    arr = (ctypes.c_float * 5)(*([float(t) for t in taps] + [0.0] * (4 - P)))
    return arr, P
