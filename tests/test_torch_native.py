"""The port's native layer (``acids_transforms_tpu_torch/native``: the exact
heap PGHI and the WAV loader / resampler in C++, built with ``g++`` at first
use) against its plain numpy versions and the JAX package's.

Tolerances: the heap phases within 1e-3 rad of the numpy heap on audible
cells (magnitude above 1e-2 of the largest: the rule of
``tests/test_dgt.py:73-84``); the loader bit-identical; the resampler within
1e-4 (``tests/test_utils.py:103-118``); ``pghi_exact`` on a chain
bit-identical to the native heap called by hand.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pghi import pghi_heap_numpy as j_heap
from acids_transforms_tpu.utils import misc as jmisc
from acids_transforms_tpu_torch import transforms as PT
from acids_transforms_tpu_torch.native import build, pghi_native, wavio_native
from acids_transforms_tpu_torch.ops.pghi import pghi_heap_numpy

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def harmonic_mag():
    """|DGT(512, 128)| of a harmonic tone (the JAX transform), and its DGT."""
    sr = 44100
    t = np.arange(16384) / sr
    x = sum(np.sin(2 * np.pi * f * t + 0.1 * i) / (i + 1) for i, f in enumerate([220, 440, 880, 1320]))
    x = (0.5 * x / np.abs(x).max()).astype(np.float32)
    dgt = PT.DGT(n_fft=512, hop_length=128, device="cpu")
    return dgt.forward(torch.as_tensor(x)).abs().numpy(), dgt


def test_builds_at_first_use_into_the_build_directory():
    lib = build.load()
    path = build.lib_path()
    assert path.exists() and Path(lib._name) == path
    assert path.parent.parent == ROOT / "acids_transforms_tpu_torch" / "_build"
    assert path.parent.name.startswith("native-") and path.name == "libattnative.so"
    assert "-march=native" not in build.FLAGS
    # the key follows the sources and the flags
    assert build._key(build._gxx()) == path.parent.name[len("native-"):]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text('extern "C" int att_broken( { return 0; }\n')
    monkeypatch.setattr(build, "SOURCES", (bad,))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.load()
    assert not list((tmp_path / "_build").glob("native-*"))     # nothing half-built left in place


def test_concurrent_first_builds_all_load(tmp_path):
    """Processes building at once (test workers) each load a whole library."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from acids_transforms_tpu_torch.native import build, pghi_native\n"
        "build.BUILD_ROOT = Path(sys.argv[1])\n"
        "import numpy as np\n"
        "m = np.ones((4, 9), np.float32)\n"
        "print(pghi_native.pghi(m, 1.0, 16, 4, 1e-2).shape, build.lib_path())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "_build")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0].split()[-1] for o in outs}) == 1
    assert len(list((tmp_path / "_build").glob("native-*"))) == 1
    assert not list((tmp_path / "_build").glob(".native-*"))


def test_heap_matches_the_numpy_heaps(harmonic_mag):
    mag, dgt = harmonic_mag
    p_cc = pghi_native.pghi(mag, dgt.gamma, 512, 128, 1e-2)
    p_np = pghi_heap_numpy(mag, dgt.gamma, 512, 128, 1e-2)
    p_jx = np.asarray(j_heap(mag, dgt.gamma, 512, 128, 1e-2))
    audible = mag > 1e-2 * mag.max()
    assert p_cc.shape == mag.shape and p_cc.dtype == np.float32
    assert np.abs(p_cc - p_np)[audible].max() < 1e-3
    assert np.abs(p_cc - p_jx)[audible].max() < 1e-3
    assert np.array_equal(p_np, p_jx)     # the two numpy heaps are one algorithm


def test_pghi_exact_runs_the_native_heap(harmonic_mag):
    mag, dgt = harmonic_mag
    m = torch.as_tensor(np.stack([mag, 0.5 * mag]))
    ph = dgt.pghi_exact(m)
    by_hand = np.stack([pghi_native.pghi(f, dgt.gamma, 512, 128, dgt._tol(None)) for f in m.numpy()])
    np.testing.assert_array_equal(ph.numpy(), by_hand)
    # the whole inversion against the JAX chain's (native or numpy heap)
    jd = JT.DGT(n_fft=512, hop_length=128)
    rj = np.asarray(jd.invert(np.asarray(m, dtype=np.float32), inversion_mode="pghi_exact"))
    rp = dgt.invert(m, inversion_mode="pghi_exact").numpy()
    assert rp.shape == rj.shape
    assert np.abs(rp - rj).max() <= 1e-4 * np.abs(rj).max()


def test_wav_loader_and_resampler(tmp_path):
    x = (0.5 * RNG.standard_normal((2, 30000))).astype(np.float32)
    p = str(tmp_path / "n.wav")
    jmisc.save_wav(p, x, 44100)
    a, sr_a = jmisc.load_wav(p)
    b, sr_b = wavio_native.load_wav(p)
    assert sr_a == sr_b == 44100
    np.testing.assert_array_equal(a, b)
    p16 = str(tmp_path / "n16.wav")
    jmisc.save_wav(p16, x, 22050, pcm16=True)
    np.testing.assert_array_equal(wavio_native.load_wav(p16)[0], jmisc.load_wav(p16)[0])
    for rates in ((44100, 22050), (22050, 44100)):
        ra, rb = jmisc.resample(x, *rates), wavio_native.resample(x, *rates)
        assert ra.shape == rb.shape and np.abs(ra - rb).max() < 1e-4
    assert wavio_native.resample(x[0], 44100, 22050).shape == (15000,)
    q = str(tmp_path / "w.wav")
    wavio_native.save_wav(q, x, 16000)
    back, sr = jmisc.load_wav(q)
    assert sr == 16000
    np.testing.assert_array_equal(back, x)
    with pytest.raises(ValueError, match="att_load_wav failed"):
        wavio_native.load_wav(str(tmp_path / "missing.wav"))


def test_public_surface_is_the_jax_packages():
    import acids_transforms_tpu.native as jn

    import acids_transforms_tpu_torch.native as pn

    assert set(pn.__all__) == set(jn.__all__)
    for name in ("pghi", "available"):
        assert callable(getattr(pn.pghi_native, name))
    for name in ("load_wav", "save_wav", "resample", "available"):
        assert callable(getattr(pn.wavio_native, name))
    assert pn.pghi_native.available() and pn.wavio_native.available()
    assert os.path.basename(build.lib_path()) == "libattnative.so"
