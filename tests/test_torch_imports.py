"""The port stands alone: it imports neither jax nor the JAX package, and it
runs on the card unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "acids_transforms_tpu_torch"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import acids_transforms_tpu_torch as att\n"
        "import acids_transforms_tpu_torch.ops.cuda.spectral, acids_transforms_tpu_torch.ops.cuda.glstep\n"
        "import acids_transforms_tpu_torch.ops.cuda.pghi_kernel, acids_transforms_tpu_torch.ops.pghi\n"
        "import acids_transforms_tpu_torch.transforms.dgt, acids_transforms_tpu_torch.ops.phase\n"
        "import acids_transforms_tpu_torch.transforms.spectral_repr\n"
        "import acids_transforms_tpu_torch.streaming, acids_transforms_tpu_torch.transforms.oadd\n"
        "import acids_transforms_tpu_torch.ops.cuda.stream_step\n"
        "import acids_transforms_tpu_torch.tools.sweep_kernel_floor\n"
        "import acids_transforms_tpu_torch.serving, acids_transforms_tpu_torch.export\n"
        "import acids_transforms_tpu_torch.utils, acids_transforms_tpu_torch.utils.bucketing\n"
        "import acids_transforms_tpu_torch.parallel, acids_transforms_tpu_torch.parallel.sharding\n"
        "import acids_transforms_tpu_torch.utils.collectives, acids_transforms_tpu_torch.utils.debug\n"
        "import acids_transforms_tpu_torch.utils.profiling, acids_transforms_tpu_torch.utils.misc\n"
        "import acids_transforms_tpu_torch.native.build, acids_transforms_tpu_torch.native.pghi_native\n"
        "import acids_transforms_tpu_torch.native.wavio_native\n"
        "assert att.parallel.shard_map_batch and att.native.pghi_native and att.utils.record_collectives\n"
        "assert att.CompiledTransform is att.serving.CompiledTransform and att.load_program\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m.startswith('acids_transforms_tpu.') or m == 'acids_transforms_tpu']\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', att.__version__)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_names_no_jax_module(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "acids_transforms_tpu", "triton"), (path, mod)


def test_default_device_raises_without_a_card():
    import torch

    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import transforms as T

    if torch.cuda.is_available():
        assert att.resolve_device(None).type == "cuda"
        return
    for build in (
        lambda: T.Mono(),
        lambda: T.STFT(n_fft=512, hop_length=128),
        lambda: T.DGT(n_fft=512, hop_length=128),
        lambda: T.Magnitude(n_fft=512),
        lambda: T.Normalize("unipolar"),
        lambda: att.resolve_device(None),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert att.resolve_device("cpu").type == "cpu"


def test_input_on_another_device_raises():
    import torch

    from acids_transforms_tpu_torch import transforms as T

    t = T.STFT(n_fft=512, hop_length=128, device="cpu")
    x = torch.zeros(2, 2000, device="meta")
    with pytest.raises(ValueError, match="lies on"):
        t.forward(x)
    with pytest.raises(ValueError, match="different devices"):
        other = T.Mono(device="cpu")
        other.device = torch.device("meta")
        other + t


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run its full course")
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_sources_are_in_the_package():
    names = {p.name for p in (PORT / "csrc").iterdir()}
    assert {"spectral.cu", "glstep.cu", "glstep_fullk.cu", "pghi.cu", "stream_step.cu",
            "dft_common.cuh", "synth_ola.cuh"} <= names
    for name in ("spectral.cu", "glstep.cu", "glstep_fullk.cu", "pghi.cu", "stream_step.cu"):
        text = (PORT / "csrc" / name).read_text()
        assert "Replaces" in text and "What bounds" in text and "Design" in text


def test_pghi_entry_points_default_to_the_card():
    """The new modules' entry points run on the card unless asked otherwise:
    a DGT built without ``device="cpu"`` raises here, and the kernel wrappers
    take their plain versions only because the tensor lies on the CPU (no
    launch is counted)."""
    import torch

    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as pk

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.DGT(n_fft=512, hop_length=128, inversion_mode="pghi")
    mag = torch.rand(1, 6, 257)
    ph = pk.pghi_phases_fused(mag, 1000.0, 512, 128)
    assert ph.shape == mag.shape and ph.device.type == "cpu"
    assert pk.launches == {"pghi_plan": 0, "pghi_phases": 0, "pghi_synthesize": 0}


def test_representation_entry_points_default_to_the_card():
    """The representation classes run on the card unless asked otherwise, and
    the new kernel wrappers (G, H, I, J) take their plain versions only
    because the tensor lies on the CPU: no launch is counted."""
    import torch

    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import glstep as gk
    from acids_transforms_tpu_torch.ops.cuda import spectral as sk

    if not torch.cuda.is_available():
        for build in (lambda: T.Polar(), lambda: T.PolarIF(),
                      lambda: T.Cartesian(), lambda: T.Phase(), lambda: T.IF()):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
    x = torch.zeros(1, 3000)
    y1, y2 = sk.fused_spectral_repr(x, 512, 128, "if", taps=(0.5, -0.25))
    assert y1.device.type == "cpu" and y2.shape == (1, 24, 257)
    sk.fused_repr_stats(x, 512, 128, "phase", taps=(0.5, -0.25))
    mag = torch.rand(1, 8, 257)
    gk.gl_project(mag, torch.ones_like(mag), torch.zeros_like(mag), 512, 128, (0.5, -0.25), torch.hann_window(512))
    step, to_rows, _ = gk.make_gl_momentum_step_fullk(mag, 512, 128, torch.ones(512), 0.5)
    step(*[to_rows(a) for a in (torch.ones_like(mag), torch.zeros_like(mag), mag, mag)])
    assert all(v == 0 for v in sk.launches.values()) and all(v == 0 for v in gk.launches.values())


def test_streaming_entry_points_default_to_the_card():
    """The streaming classes run on the card unless asked otherwise, and the
    session wrappers (R, L, M, P) take their plain versions only because the
    tensor lies on the CPU: no launch is counted."""
    import torch

    from acids_transforms_tpu_torch import streaming
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import stream_step as sk

    if not torch.cuda.is_available():
        for build in (lambda: T.OverlapAdd(512, 128), lambda: T.RealtimeSTFT(n_fft=512, hop_length=128),
                      lambda: T.RealtimeDGT(n_fft=512, hop_length=128)):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
    chain = T.OverlapAdd(512, 128, device="cpu") + T.RealtimeSTFT(n_fft=512, hop_length=128, device="cpu")
    x = torch.zeros(1, 3000)
    sk.reset_launches()
    streaming.scan_forward(chain, x, 1024, backend="fused")
    streaming.scan_roundtrip(chain, x, 1024, backend="fused")
    streaming.scan_roundtrip(chain, x, 1024, "random", backend="fused")
    streaming.scan_invert(chain, torch.ones(1, 20, 257), 8, "random", backend="fused")
    assert all(v == 0 for v in sk.launches.values())
    assert streaming.plan_roundtrip(chain, (1, 3000), 1024) == "complex"   # device None: the card


def test_config_2_and_3_entry_points_default_to_the_card():
    """The raw, layout and MFCC classes run on the card unless asked
    otherwise; the MFCC fused forward takes kernel A's plain version only
    because the tensor lies on the CPU (no launch is counted); an input on
    another device raises, through the fused forward too."""
    import torch

    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import spectral as sk

    builds = {
        "MFCC": lambda **kw: T.MFCC(n_fft=512, hop_length=128, **kw),
        "MidSide": lambda **kw: T.MidSide(**kw), "Stereo": lambda **kw: T.Stereo(**kw),
        "MuLaw": lambda **kw: T.MuLaw(one_hot="categorical", **kw), "OneHot": lambda **kw: T.OneHot(n_classes=4, **kw),
        "Window": lambda **kw: T.Window(window_size=256, hop_size=64, **kw),
        "Unsqueeze": lambda **kw: T.Unsqueeze(**kw), "Squeeze": lambda **kw: T.Squeeze(dim=1, **kw),
        "Transpose": lambda **kw: T.Transpose(**kw),
    }
    if not torch.cuda.is_available():
        for name, build in builds.items():
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
        with pytest.raises(RuntimeError, match="CUDA"):
            att.fuse_forward(T.Mono() + T.MFCC())
    chain = T.Mono(device="cpu") + builds["MFCC"](device="cpu")
    sk.reset_launches()
    y = att.fuse_forward(chain, backend="kernel")(torch.zeros(1, 2, 3000))
    assert y.shape == (1, 128, 24) and y.device.type == "cpu"
    assert all(v == 0 for v in sk.launches.values())
    meta = torch.zeros(2, 2, 2000, device="meta")
    for name, build in builds.items():
        with pytest.raises(ValueError, match="lies on"):
            build(device="cpu").forward(meta if name != "OneHot" else meta.long())
    for backend in ("kernel", "eager"):
        with pytest.raises(ValueError, match="lies on"):
            att.fuse_forward(builds["MFCC"](device="cpu"), backend=backend)(meta[:, 0])
