"""Build the native host library (``pghi.cc``, ``wavio.cc``) at first use.

``g++ -O3 -shared -fPIC -std=c++17`` compiles the two sources beside this
file into ``acids_transforms_tpu_torch/_build/native-<hash>/libattnative.so``,
keyed by a hash of the sources, the flags and ``g++ --version``: a changed
source or compiler rebuilds, an unchanged one is reused.  The build goes to a
temporary directory that is then renamed into place, so that processes
building at once (test workers) never load a half-written library.  A failed
build raises with the compiler's output; nothing falls back to numpy.

``python -m acids_transforms_tpu_torch.native.build`` builds it ahead of time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

__all__ = ["FLAGS", "SOURCES", "load", "lib_path"]

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parent / "_build"
SOURCES = (HERE / "pghi.cc", HERE / "wavio.cc")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libattnative.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native library is built from source at first use")
    return gxx


def _key(gxx: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout.encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    """Where the library for these sources, flags and compiler lives."""
    return BUILD_ROOT / ("native-" + _key(_gxx())) / LIB_NAME


def _build(target: Path, gxx: str) -> None:
    target.parent.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".native-", dir=target.parent.parent))
    try:
        cmd = [gxx, *FLAGS, *map(str, SOURCES), "-o", str(tmp / LIB_NAME)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("g++ failed:\n$ %s\n%s%s" % (" ".join(cmd), res.stdout, res.stderr))
        try:
            os.replace(tmp, target.parent)  # atomic: another process may have won the race
        except OSError:
            if not target.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The native library, built on the first call of this process that
    finds none for these sources."""
    global _lib
    with _lock:
        if _lib is None:
            target = lib_path()
            if not target.exists():
                _build(target, _gxx())
            _lib = ctypes.CDLL(str(target))
        return _lib


if __name__ == "__main__":
    print(load()._name)
