"""``acids_transforms_tpu_torch/export.py`` against the JAX package's
``export.py`` on the CPU: npz checkpoints cross between the packages both
ways for every transform class (the 22 makers of ``tests/test_export.py``),
``torch.export`` keeps kernel A in the program as the registered operator
(its CPU implementation, the plain version, runs here), and
``invert_with_phase_fn`` matches JAX's.

Tolerances: the forward of a loaded checkpoint is held to the JAX twin with
the tolerance the class's own port tests use (max-abs over max-abs: 0 for
the raw and layout transforms, 1e-6 for the normalizer, 5e-5 where the JAX
side runs a Precision.HIGH GEMM, 1e-4 for MFCC's DCT and the IF stencil);
where both sides are the port, bit-identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch as patt
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.export import invert_with_phase_fn as j_invert_with_phase_fn
from acids_transforms_tpu.export import load_transform as j_load
from acids_transforms_tpu.export import save_transform as j_save
from acids_transforms_tpu_torch.export import (
    _aux_of,
    export_program,
    invert_with_phase_fn,
    load_program,
    load_transform,
    save_transform,
)
from acids_transforms_tpu_torch.ops.cuda import spectral as sk
from test_torch_common import carry_over, chains, make_audio, rel, t2n

GEMM_TOL = 5e-5  # JAX Precision.HIGH GEMMs on one side
D = "cpu"


def _audio(shape, seed=0):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, shape).astype(np.float32)


def _spec(bins, seed=1):
    """Complex (2, 12, bins) with |z| in [0.5, 1.5]: angles well conditioned."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(0.5, 1.5, (2, 12, bins))
    return (mag * np.exp(1j * rng.uniform(-np.pi, np.pi, mag.shape))).astype(np.complex64)


#: (name, JAX maker, port maker, input, tolerance); None: bit-identical
CASES = [
    ("Mono", lambda M, **k: M.Mono(**k), lambda: _audio((2, 2, 4096)), None),
    ("Stereo", lambda M, **k: M.Stereo(**k), lambda: _audio((2, 1, 4096)), None),
    ("MidSide", lambda M, **k: M.MidSide(pad_mid=False, **k), lambda: _audio((2, 2, 4096)), None),
    ("Window", lambda M, **k: M.Window(window_size=512, hop_size=256, **k), lambda: _audio((2, 4096)), None),
    ("MuLaw", lambda M, **k: M.MuLaw(channels=128, one_hot="categorical", **k), lambda: _audio((2, 4096)), None),
    ("STFT", lambda M, **k: M.STFT(n_fft=512, hop_length=128, window="hamming", **k),
     lambda: _audio((2, 4096)), GEMM_TOL),
    ("RealtimeSTFT", lambda M, **k: M.RealtimeSTFT(n_fft=512, hop_length=128, **k),
     lambda: _audio((2, 5, 512)), GEMM_TOL),
    ("DGT", lambda M, **k: M.DGT(n_fft=512, hop_length=128, tolerance=5e-3, **k),
     lambda: _audio((2, 4096)), GEMM_TOL),
    ("RealtimeDGT", lambda M, **k: M.RealtimeDGT(n_fft=512, hop_length=128, **k),
     lambda: _audio((2, 5, 512)), GEMM_TOL),
    ("MFCC", lambda M, **k: M.MFCC(n_fft=512, hop_length=128, n_mels=32, n_mfcc=13, **k),
     lambda: _audio((2, 4096)), 1e-4),
    ("Magnitude", lambda M, **k: M.Magnitude(mode="unipolar", mel=True, n_fft=512, mel_inverse="pinv", **k),
     lambda: _spec(257), GEMM_TOL),
    ("Phase", lambda M, **k: M.Phase(mode="bipolar", unwrap=True, **k), lambda: _spec(257), 1e-5),
    ("IF", lambda M, **k: M.IF(method="central", weighted=True, **k), lambda: _spec(257), 1e-4),
    ("Cartesian", lambda M, **k: M.Cartesian(**k), lambda: _spec(257), 1e-5),
    ("Polar", lambda M, **k: M.Polar(**k), lambda: _spec(513), 1e-4),
    ("PolarIF", lambda M, **k: M.PolarIF(**k), lambda: _spec(513), 1e-4),
    ("Normalize", lambda M, **k: M.Normalize(mode="bipolar", **k), lambda: _audio((3, 40, 17)), 1e-6),
    ("OverlapAdd", lambda M, **k: M.OverlapAdd(512, 128, **k), lambda: _audio((2, 1024)), None),
    ("Unsqueeze", lambda M, **k: M.Unsqueeze(dim=1, **k), lambda: _audio((2, 3, 5)), None),
    ("Squeeze", lambda M, **k: M.Squeeze(dim=1, **k), lambda: _audio((2, 1, 5)), None),
    ("Transpose", lambda M, **k: M.Transpose(**k), lambda: _audio((2, 3, 5)), None),
    ("OneHot", lambda M, **k: M.OneHot(n_classes=64, **k),
     lambda: np.random.default_rng(2).integers(0, 64, (2, 50)).astype(np.int32), None),
]
IDS = [c[0] for c in CASES]


def _jax_tree_equal(a, b):
    (l1, a1), (l2, a2) = a._tree_flatten(), b._tree_flatten()
    assert a1 == a2
    for x, y in zip(jax.tree_util.tree_leaves(l1), jax.tree_util.tree_leaves(l2)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-7)


def _port_buffers_identical(a, b):
    ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
    assert set(ba) == set(bb)
    for k in ba:
        assert ba[k].dtype == bb[k].dtype and torch.equal(ba[k], bb[k]), k


def _compare(yp, yj, tol):
    yp, yj = t2n(yp), np.asarray(yj)
    assert yp.shape == yj.shape
    if tol is None:
        assert np.array_equal(yp, yj)
    else:
        assert rel(yp, yj) <= tol, rel(yp, yj)


@pytest.mark.parametrize("name, make, data, tol", CASES, ids=IDS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, name, make, data, tol):
    jt = make(JT)
    path = str(tmp_path / "t.npz")
    j_save(jt, path)
    pt = load_transform(path, device=D)
    assert type(pt).__name__ == name and _aux_of(pt) == _aux_of(make(PT, device=D))
    x = data()
    _compare(pt.forward(torch.as_tensor(x)), jt.forward(jnp.asarray(x)), tol)


@pytest.mark.parametrize("name, make, data, tol", CASES, ids=IDS)
def test_port_checkpoint_loads_in_jax_and_back(tmp_path, name, make, data, tol):
    pt = make(PT, device=D)
    path = str(tmp_path / "t.npz")
    save_transform(pt, path)
    jt = j_load(path)
    assert type(jt) is type(make(JT))
    _jax_tree_equal(jt, make(JT))       # aux equal to the JAX twin's, leaves allclose
    back = load_transform(path, device=D)
    assert type(back) is type(pt) and _aux_of(back) == _aux_of(pt)
    _port_buffers_identical(back, pt)


def test_fitted_chain_crosses_both_ways(tmp_path):
    """The flagship chain fitted in JAX: its checkpoint forwards in the port
    like the JAX chain; the port's checkpoint of it loads in JAX with the
    same statistics and bit-identical buffers in the port; the STFT seed
    rides as JAX's PRNG key."""
    jc, pc = chains()
    x = make_audio(3, batch=2, n=6000)
    jf = jc.fit(jnp.asarray(x))
    path = str(tmp_path / "j.npz")
    j_save(jf, path)
    pl = load_transform(path, device=D)
    assert isinstance(pl, PT.ComposeAudioTransform) and len(pl) == 3 and not pl[2].norm.needs_scaling
    yj = np.asarray(jf.forward(jnp.asarray(x)))
    assert rel(t2n(pl.forward(torch.as_tensor(x))), yj) <= GEMM_TOL
    carry_over(jf, pc)
    pc[1].seed = 7
    path2 = str(tmp_path / "p.npz")
    save_transform(pc, path2)
    j2 = j_load(path2)
    assert np.array_equal(np.asarray(j2[1].rng), np.asarray(jax.random.PRNGKey(7)))
    assert float(j2[2].norm.offset) == float(jf[2].norm.offset)
    assert float(j2[2].norm.scale) == float(jf[2].norm.scale)
    assert rel(np.asarray(j2.forward(jnp.asarray(x))), yj) <= 1e-6
    p2 = load_transform(path2, device=D)
    assert p2[1].seed == 7
    _port_buffers_identical(p2, pc)
    assert torch.equal(p2.forward(torch.as_tensor(x)), pc.forward(torch.as_tensor(x)))


def test_loader_takes_no_module_from_the_file(tmp_path):
    import json

    pt = PT.Mono(device=D)
    path = str(tmp_path / "m.npz")
    save_transform(pt, path)
    data = dict(np.load(path))
    manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
    assert manifest["module"] == "acids_transforms_tpu.transforms.raw" and manifest["cls"] == "Mono"
    manifest["module"] = "os"
    data["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="no class"):
        load_transform(path, device=D)


def test_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "m.npz")
    save_transform(PT.Mono(device=D), path)
    if torch.cuda.is_available():
        assert load_transform(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            load_transform(path)


def _fitted_port_chain(x):
    jc, pc = chains()
    carry_over(jc.fit(jnp.asarray(x)), pc)
    return pc


def test_export_program_keeps_kernel_a_and_serves_any_batch(tmp_path):
    x = make_audio(4, batch=3, n=4096)
    pc = _fitted_port_chain(x)
    fwd = patt.fuse_forward(pc, backend="kernel")
    path = str(tmp_path / "p.pt2")
    many = torch.as_tensor(np.tile(x, (20, 1, 1)))      # the example a view of 60 clips
    blob = export_program(fwd, (many[:3],), path=path, polymorphic_batch=True)
    assert open(path, "rb").read() == blob
    assert len(blob) < 2 * many.numel()    # the example's storage is not in the program
    prog = load_program(blob)
    ops = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
    assert "acids_transforms_tpu_torch.fused_melspec.default" in ops, ops
    sk.reset_launches()
    for b in (1, 3, 5):
        xb = torch.as_tensor(np.tile(x[:1], (b, 1, 1)))
        y = prog(xb)
        assert torch.equal(y, fwd(xb)) and y.shape[0] == b
        assert rel(t2n(y), t2n(pc.forward(xb))) <= 1e-4
    assert sk.op_calls["fused_melspec"] == 0 and all(v == 0 for v in sk.launches.values())
    assert torch.equal(load_program(path)(torch.as_tensor(x)), fwd(torch.as_tensor(x)))


def test_export_program_int16_ingest():
    x = make_audio(5, batch=2, n=4096)
    xi = torch.as_tensor(np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16))
    xf = xi.to(torch.float32) / 32768.0
    pc = _fitted_port_chain(xf.numpy())
    fwd = patt.fuse_forward(pc, backend="kernel")
    y_i = load_program(export_program(fwd, (xi,)))(xi)
    y_f = load_program(export_program(fwd, (xf,)))(xf)
    assert torch.equal(y_i, y_f) and torch.equal(y_i, fwd(xi))


def test_export_program_refuses_shardings():
    """``in_shardings`` (tests/test_torch_parallel.py exports and runs it on
    4 ranks) refuses a polymorphic batch, as in JAX, and a batch that does
    not divide over the mesh axis."""
    from test_torch_common import Mesh4

    with pytest.raises(ValueError, match="exclusive"):
        export_program(lambda v: v, (torch.zeros(8, 2),), in_shardings=Mesh4(), polymorphic_batch=True)
    with pytest.raises(ValueError, match="divisible by mesh axis 'data' size 4"):
        export_program(lambda v: v, (torch.zeros(2, 2),), in_shardings=Mesh4())


def test_registered_op_is_the_plain_version_on_the_cpu():
    """The operator's CPU implementation is kernel A's plain version (the
    rule "plain only because the tensor lies on the CPU"); its fake
    implementation gives the shape of both."""
    x = torch.as_tensor(make_audio(6, batch=2, n=3000)[:, 0])
    bank = PT.Magnitude(n_fft=512, device=D).mel_bank
    kw = dict(mel_bank=bank, offset=0.25, scale=2.0, contrast="log1p", taps=(0.5, -0.25))
    y = sk.fused_melspec_op(x, 512, 128, **kw)
    assert torch.equal(y, sk.fused_melspec_reference(x, 512, 128, **kw))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        yf = sk.fused_melspec_op(mode.from_tensor(x), 512, 128, **dict(kw, mel_bank=mode.from_tensor(bank)))
    assert tuple(yf.shape) == tuple(y.shape) and yf.dtype == y.dtype


def test_invert_with_phase_matches_jax():
    x = make_audio(7, batch=3, n=4096).mean(1)
    jc = (JT.STFT(n_fft=512, hop_length=128) + JT.Magnitude(
        mode="unipolar", contrast="log1p", mel=False, n_fft=512)).fit(jnp.asarray(x))
    pc = PT.STFT(n_fft=512, hop_length=128, device=D) + PT.Magnitude(
        mode="unipolar", contrast="log1p", mel=False, n_fft=512, device=D)
    carry_over(jc, pc)
    y = jc.forward(jnp.asarray(x))
    phase = jnp.angle(jc[0].forward(jnp.asarray(x)))
    rj = np.asarray(jax.jit(j_invert_with_phase_fn(jc))(y, phase))
    rp = t2n(invert_with_phase_fn(pc)(torch.as_tensor(np.array(y)), torch.as_tensor(np.array(phase))))
    assert rp.shape == rj.shape and rel(rp, rj) <= 1e-4
    n = rp.shape[-1]
    assert rel(rp, x[..., :n]) <= 1e-4          # the exact keep_input roundtrip
    with pytest.raises(ValueError):
        invert_with_phase_fn(PT.Mono(device=D) + PT.MuLaw(device=D))
