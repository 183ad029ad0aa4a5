"""The layout transforms (``transforms/misc.py``: Unsqueeze, Squeeze,
Transpose, OneHot), the protocol leftovers of ``transforms/base.py``
(``output_frame_axis`` and its chain fold, the list helpers, the
``test_forward`` / ``test_inversion`` / ``test_jit_transform`` hooks),
``OverlapAdd.reset``, ``RealtimeSTFT.get_batch_size`` / ``set_batch_size``,
``ops/framing.py:reshape_batches`` and ``ops/fft.py``'s ``impl="matmul2"`` and
``set_matmul_precision``, against the JAX package on the same numpy inputs.

Tolerances, and why:

* layout transforms, OneHot, the frame axis, the list helpers: equal (no
  arithmetic; OneHot is int32 as in the JAX package);
* the hooks: what the JAX hook returns, bit-identical where the hook does no
  arithmetic, within an ulp where XLA's jit or the libraries' ``pow`` round
  differently, and within 1e-5 of the largest value where an STFT runs
  (float32 products summed in another order); the angle channels' forward
  hooks are held to the port's own fit and forward (an angle at the cut may
  land on either side); hooks that draw random phases or codes are held by
  shape, dtype and roundtrip, since the two packages' generators differ;
* ``matmul2``: within 1e-5 of the largest magnitude against JAX's
  ``stft(impl="matmul2")`` and a float64 ``np.fft.rfft`` oracle;
* the default matmul precision ("highest", full float32): the STFT within
  1e-5 of the float64 oracle, the 1e-4 budget with a decade to spare.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.framing import reshape_batches as j_reshape_batches
from acids_transforms_tpu_torch.convert import load_jax_state
from acids_transforms_tpu_torch.ops import fft as pfft
from acids_transforms_tpu_torch.ops.framing import frame as p_frame
from acids_transforms_tpu_torch.ops.framing import reshape_batches as p_reshape_batches
from acids_transforms_tpu_torch.transforms.base import (
    apply_invert_transform_to_list,
    apply_transform_to_list,
)
from test_torch_common import make_audio, rel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def audio():
    return make_audio(43, batch=2, n=4096)           # (2, 2, 4096)


def same(a, b):
    a, b = np.asarray(a), b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


LAYOUT = [
    ("Unsqueeze", {"dim": 1}), ("Unsqueeze", {"dim": -1}), ("Unsqueeze", {"dim": -3}),
    ("Squeeze", {"dim": 1}), ("Squeeze", {"dim": -2}), ("Squeeze", {"dim": None}), ("Squeeze", {"dim": -1}),
    ("Transpose", {"dims": (-2, -1)}), ("Transpose", {"dims": (0, 2)}), ("Transpose", {"dims": (-3, -1)}),
]


@pytest.mark.parametrize("name,kw", LAYOUT, ids=lambda v: str(v))
def test_layout_transforms_vs_jax(audio, name, kw):
    x = audio[:, :1].copy() if name == "Squeeze" else audio       # (2, 1, L) has a singleton to drop
    jt, pt = getattr(JT, name)(**kw), getattr(PT, name)(device="cpu", **kw)
    yj, yp = jt.forward(jnp.asarray(x)), pt.forward(torch.as_tensor(x))
    same(yj, yp)
    assert jt.invertible == pt.invertible
    if pt.invertible:
        same(jt.invert(yj), pt.invert(yp))
    else:
        with pytest.raises(PT.NotInvertibleError):
            pt.invert(yp)
    for axis_in in (None, -1, -2, -3):
        assert pt.output_frame_axis(axis_in) == jt.output_frame_axis(axis_in), axis_in
    mask = (np.arange(x.shape[-1]) < 3000).astype(np.float32) * np.ones(x.shape, np.float32)
    mj = jt.propagate_mask(jnp.asarray(mask), jnp.asarray(x))
    mp = pt.propagate_mask(torch.as_tensor(mask), torch.as_tensor(x))
    assert (mj is None) == (mp is None)
    if mj is not None:
        same(mj, mp)


def test_transpose_contiguous_and_squeeze_of_a_wide_axis(audio):
    x = torch.as_tensor(audio)
    assert PT.Transpose(device="cpu").forward(x).is_contiguous()
    assert not PT.Transpose(contiguous=False, device="cpu").forward(x).is_contiguous()
    same(JT.Squeeze(dim=1).forward(jnp.asarray(audio)), PT.Squeeze(dim=1, device="cpu").forward(x))


def test_onehot_fit_forward_invert_vs_jax():
    codes = np.random.default_rng(3).integers(0, 200, (2, 1000)).astype(np.int32)
    mask = (np.arange(1000) < 600).astype(np.float32)[None]
    codes[:, 600:] = 250                                       # only the padding reaches 250
    jt, pt = JT.OneHot(), PT.OneHot(device="cpu")
    assert jt.needs_scaling and pt.needs_scaling
    with pytest.raises(ValueError, match="before scale_data"):
        pt.forward(torch.as_tensor(codes))
    jf, pf = jt.fit(jnp.asarray(codes)), pt.fit(torch.as_tensor(codes))
    assert pf.n_classes == jf.n_classes == 251 and pt.n_classes == -1 and not pf.needs_scaling
    jm, pm = jt.fit(jnp.asarray(codes), mask=jnp.asarray(mask)), pt.fit(torch.as_tensor(codes), mask=torch.as_tensor(mask))
    assert pm.n_classes == jm.n_classes == int(codes[:, :600].max()) + 1
    pt.scale_data(torch.as_tensor(codes))
    jt.scale_data(jnp.asarray(codes))
    assert pt.n_classes == jt.n_classes
    yj, yp = jt.forward(jnp.asarray(codes)), pt.forward(torch.as_tensor(codes))
    assert yp.dtype == torch.int32
    same(yj, yp)
    same(np.asarray(jt.invert(yj)).astype(np.int64), pt.invert(yp))
    # a code outside [0, n_classes) one-hots to zeros, as jax.nn.one_hot does
    small = PT.OneHot(n_classes=4, device="cpu").forward(torch.tensor([0, 3, 4, -1]))
    same(np.asarray(JT.OneHot(n_classes=4).forward(jnp.asarray([0, 3, 4, -1]))), small)


def test_onehot_codes_come_from_the_generator(audio):
    x = torch.as_tensor(audio)
    t = PT.OneHot(device="cpu")
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = t.test_forward(x, generator=g1), t.test_forward(x, generator=g2)
    assert torch.equal(a, b) and a.shape == (2, 2, 1000, t.n_classes) and a.dtype == torch.int32
    inv = PT.OneHot(device="cpu").test_inversion(x, generator=torch.Generator().manual_seed(5))["inverted"]
    codes = PT.OneHot(device="cpu")._test_codes(x, torch.Generator().manual_seed(5))
    assert torch.equal(inv, codes)


def test_onehot_class_count_carried_from_jax():
    codes = np.random.default_rng(4).integers(0, 77, (3, 50))
    jf = JT.OneHot().fit(jnp.asarray(codes))
    pc = load_jax_state(PT.Mono(device="cpu") + PT.OneHot(device="cpu"), {"1.n_classes": np.asarray(jf.n_classes)})
    assert pc[1].n_classes == jf.n_classes and not pc[1].needs_scaling
    same(jf.forward(jnp.asarray(codes)), pc[1].forward(torch.as_tensor(codes)))


# --------------------------------------------------------------- frame axis
def frame_axis_cases():
    return {
        "STFT": lambda M: M.STFT(n_fft=256, hop_length=64, **dev(M)),
        "DGT": lambda M: M.DGT(n_fft=256, hop_length=64, **dev(M)),
        "OverlapAdd": lambda M: M.OverlapAdd(256, 64, **dev(M)),
        "RealtimeSTFT": lambda M: M.RealtimeSTFT(n_fft=256, hop_length=64, **dev(M)),
        "Window": lambda M: M.Window(window_size=256, hop_size=64, **dev(M)),
        "Window_dim0": lambda M: M.Window(window_size=256, hop_size=64, dim=0, **dev(M)),
        "MFCC": lambda M: M.MFCC(n_fft=256, hop_length=64, n_mels=32, **dev(M)),
        "Mono": lambda M: M.Mono(**dev(M)),
        "MuLaw": lambda M: M.MuLaw(**dev(M)),
        "Magnitude": lambda M: M.Magnitude(**dev(M)),
        "Polar": lambda M: M.Polar(**dev(M)),
        "Polar_stack3": lambda M: M.Polar(stack=-3, **dev(M)),
        "Polar_tuple": lambda M: M.Polar(stack=None, **dev(M)),
        "Polar_front": lambda M: M.Polar(stack=1, **dev(M)),
        "PolarIF": lambda M: M.PolarIF(stack=-1, **dev(M)),
        "Cartesian": lambda M: M.Cartesian(**dev(M)),
        "Normalize": lambda M: M.Normalize(**dev(M)),
    }


def dev(M):
    return {"device": "cpu"} if M is PT else {}


@pytest.mark.parametrize("name", sorted(frame_axis_cases()))
def test_output_frame_axis_per_class(name):
    build = frame_axis_cases()[name]
    jt, pt = build(JT), build(PT)
    for axis_in in (None, -1, -2, -3, -4):
        assert pt.output_frame_axis(axis_in) == jt.output_frame_axis(axis_in), axis_in


CHAINS = {
    "logmel": ["Mono", "STFT", "Magnitude"],
    "polar_transposed": ["Mono", "STFT", "Polar_stack3", "Transpose"],
    "stream": ["OverlapAdd", "RealtimeSTFT", "PolarIF"],
    "mfcc_unsqueezed": ["Mono", "MFCC", "Unsqueeze"],
    "window_squeezed": ["Window", "Squeeze"],
    "front_stack": ["Mono", "STFT", "Polar_front", "Transpose"],
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_output_frame_axis_folds_over_chains(name):
    builds = dict(frame_axis_cases(), Transpose=lambda M: M.Transpose(dims=(-3, -2), **dev(M)),
                  Unsqueeze=lambda M: M.Unsqueeze(dim=-2, **dev(M)), Squeeze=lambda M: M.Squeeze(dim=-3, **dev(M)))
    parts = CHAINS[name]
    jc = JT.ComposeAudioTransform([builds[p](JT) for p in parts])
    pc = PT.ComposeAudioTransform([builds[p](PT) for p in parts])
    for axis_in in (None, -1, -2):
        assert pc.output_frame_axis(axis_in) == jc.output_frame_axis(axis_in)


# ---------------------------------------------------------------- the hooks
def hook_cases():
    """name -> (constructor, input kind): "audio" (B, 2, L), "mono" (B, L),
    "mono1" (B, 1, L), "spec" (mono clips; the traced forward takes their
    STFT)."""
    return {
        "Mono": (lambda M: M.Mono(**dev(M)), "audio"),
        "Stereo": (lambda M: M.Stereo(**dev(M)), "audio"),
        "MidSide": (lambda M: M.MidSide(**dev(M)), "audio"),
        "Window": (lambda M: M.Window(window_size=256, hop_size=64, **dev(M)), "audio"),
        "MuLaw": (lambda M: M.MuLaw(**dev(M)), "audio"),
        "MuLaw_channel": (lambda M: M.MuLaw(one_hot="channel", **dev(M)), "mono"),
        "Unsqueeze": (lambda M: M.Unsqueeze(**dev(M)), "audio"),
        "Squeeze": (lambda M: M.Squeeze(dim=-2, **dev(M)), "mono1"),
        "Transpose": (lambda M: M.Transpose(**dev(M)), "audio"),
        "MFCC": (lambda M: M.MFCC(n_fft=256, hop_length=64, n_mels=32, norm_mode="unipolar", **dev(M)), "mono"),
        "Normalize": (lambda M: M.Normalize("gaussian", **dev(M)), "mono"),
        "OverlapAdd": (lambda M: M.OverlapAdd(256, 64, **dev(M)), "mono"),
        "Magnitude": (lambda M: M.Magnitude(mode="unipolar", contrast="log1p", mel=True, **dev(M)), "spec"),
        "Real": (lambda M: M.Real(mode="gaussian", **dev(M)), "spec"),
        "Imaginary": (lambda M: M.Imaginary(mode="gaussian", **dev(M)), "spec"),
        "Phase": (lambda M: M.Phase(mode="bipolar", **dev(M)), "spec"),
        "IF": (lambda M: M.IF(mode="bipolar", **dev(M)), "spec"),
        "Polar": (lambda M: M.Polar(**dev(M)), "spec"),
        "PolarIF": (lambda M: M.PolarIF(**dev(M)), "spec"),
        "Cartesian": (lambda M: M.Cartesian(**dev(M)), "spec"),
    }


def hook_input(kind, audio, M):
    """The hooks' input: a representation's hooks run an STFT themselves."""
    mono = audio.mean(1)
    arr = {"audio": audio, "mono1": mono[:, None]}.get(kind, mono)
    return jnp.asarray(arr) if M is JT else torch.as_tensor(arr)


def close(a, b, tol):
    """``tol``: "exact", "ulp" (1 ulp: the same operations, fused or
    reassociated by XLA's jit or by the two libraries' ``pow``), or a bound
    relative to the largest value."""
    if isinstance(a, (tuple, list)):
        for u, v in zip(a, b):
            close(u, v, tol)
        return
    a = np.asarray(a)
    b = b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if tol == "exact" or a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b)
    elif tol == "ulp":
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
    else:
        assert rel(b, a) <= tol, rel(b, a)


#: per class: (test_forward, test_inversion, test_jit_transform) tolerances.
#: STFT-fed hooks and fits sum in another order than the JAX package (1e-5);
#: MidSide's jitted forward and MuLaw's decode differ by an ulp; the JAX
#: package's representations have no test_jit_transform for spectra, so the
#: port's traced forward is held against its own eager forward there.
TOLS = {"MidSide": ("exact", "exact", "ulp"), "MuLaw": ("exact", 1e-6, "exact"),
        "MuLaw_channel": ("exact", 1e-6, "exact"), "Window": ("exact", "exact", "exact")}
ANGLES = {"Phase", "IF", "Polar", "PolarIF"}
SPEC_FED = {"Magnitude", "Real", "Imaginary", "Phase", "IF", "Polar", "PolarIF", "Cartesian"}


@pytest.mark.parametrize("name", sorted(hook_cases()))
def test_hooks_vs_jax(audio, name):
    build, kind = hook_cases()[name]
    t_fwd, t_inv, t_jit = TOLS.get(name, ("exact",) * 3 if kind in ("audio", "mono1") else (1e-5,) * 3)
    jt, pt = build(JT), build(PT)
    xj, xp = hook_input(kind, audio, JT), hook_input(kind, audio, PT)
    if name in ANGLES:
        # angles at the +-pi cut and at silent bins may land on either side
        # (the channel's parity is held in test_torch_spectral_repr.py): the
        # hook is held to the port's own fit and forward of the hook's STFT,
        # and to the JAX hook's shape
        yp = pt.test_forward(xp)
        spec = PT.STFT(device="cpu").forward(xp)
        close(build(PT).fit(spec).forward(spec), yp, "exact")
        assert tuple(jt.test_forward(xj).shape) == tuple(yp.shape)
    else:
        close(jt.test_forward(xj), pt.test_forward(xp), t_fwd)
    tj = jnp.arange(xj.shape[0], dtype=jnp.float32)
    if kind in ("audio", "mono") and name not in ("OverlapAdd", "Normalize"):
        (yj, tjo), (yp, tpo) = build(JT).test_forward(xj, tj), build(PT).test_forward(xp, torch.as_tensor(np.asarray(tj)))
        close(yj, yp, t_fwd)
        close(tjo, tpo, "exact")
    if pt.invertible:
        oj, op = build(JT).test_inversion(xj), build(PT).test_inversion(xp)
        assert sorted(oj) == sorted(op)
        for k in oj:
            if name in ("Phase", "IF"):
                # phases: on the circle, weighted by |X| / max |X| (a quiet
                # bin's angle is only as good as its magnitude)
                d = np.angle(np.exp(1j * (np.asarray(oj[k], np.float64) - op[k].numpy())))
                mag = PT.STFT(device="cpu").forward(xp).abs().numpy()
                assert np.abs(d * mag / mag.max()).max() <= 1e-5
            else:
                close(oj[k], op[k], t_inv)
    else:
        with pytest.raises(NotImplementedError):
            pt.test_inversion(xp)
    pj = build(PT)
    if name in SPEC_FED:
        xp = PT.STFT(device="cpu").forward(xp)
    y = pj.test_jit_transform(xp)
    if name in SPEC_FED:
        close(build(PT).forward(xp) if not pj.needs_scaling else pj.forward(xp), y, "exact")
    else:
        close(build(JT).test_jit_transform(xj), y, t_jit)


@pytest.mark.parametrize("name", ["STFT", "DGT", "RealtimeSTFT", "RealtimeDGT", "OneHot"])
def test_hooks_of_the_drawing_classes(audio, name):
    """Hooks that draw random phases or codes: every mode the port has, the
    shapes of the JAX package's hooks, finite values."""
    mono = audio.mean(1)
    kw = {} if name == "OneHot" else dict(n_fft=256, hop_length=64)
    if name == "STFT":
        kw["gl_iterations"] = 2
    jt, pt = getattr(JT, name)(**kw), getattr(PT, name)(device="cpu", **kw)
    fj, fp = jt.test_forward(jnp.asarray(mono)), pt.test_forward(torch.as_tensor(mono))
    assert tuple(fj.shape) == tuple(fp.shape)
    op = pt.test_inversion(torch.as_tensor(mono))
    if name == "OneHot":
        assert tuple(op["inverted"].shape) == (2, 1000)
        return
    ported = set(op)
    assert ported == {"direct"} | set(pt.get_inversion_modes())
    for k, v in op.items():
        assert torch.isfinite(v).all() and v.shape[:-1] == (2,), k
    if name.startswith("Realtime"):
        frames = p_frame(torch.as_tensor(mono), 256, 64)
        y = pt.test_jit_transform(frames)
        assert y.shape == (2, frames.shape[1], 129)
    else:
        y = pt.test_jit_transform(torch.as_tensor(mono))
        assert torch.allclose(y, pt.forward(torch.as_tensor(mono)))


# ------------------------------------------------------------ other leftovers
def test_list_helpers_vs_jax(audio):
    data = [audio[0], audio[1, :, :3000].copy()]
    times = [np.zeros(2, np.float32), np.ones(2, np.float32)]
    jt, pt = JT.Mono(), PT.Mono(device="cpu")
    for a, b in zip(apply_transform_to_list(pt, [torch.as_tensor(d) for d in data]),
                    [jt.forward(jnp.asarray(d)) for d in data]):
        same(b, a)
    ys, ts = apply_transform_to_list(pt, [torch.as_tensor(d) for d in data], [torch.as_tensor(t) for t in times])
    assert [float(t) for t in ts] == [0.0, 1.0] and ys[1].shape == (3000,)
    inv = apply_invert_transform_to_list(pt, ys, inversion_mode="stereo")
    assert [tuple(v.shape) for v in inv] == [(2, 4096), (2, 3000)]
    inv, tt = apply_invert_transform_to_list(pt, ys, ts)
    assert tt == ts and inv[0].shape == (1, 4096)
    from acids_transforms_tpu.transforms.base import apply_invert_transform_to_list as j_inv

    same(j_inv(jt, [jt.forward(jnp.asarray(d)) for d in data])[1], inv[1])


def test_overlap_add_reset_and_realtime_batch_size():
    oa = PT.OverlapAdd(256, 64, device="cpu")
    x = torch.randn(3, 512, generator=torch.Generator().manual_seed(0))
    first = oa.forward(x)
    oa.forward(x)
    oa.reset((3,))
    assert torch.equal(oa.forward(x), first)
    assert oa._state["input_buffer"].shape == (3, 192)
    rt = PT.RealtimeSTFT(n_fft=256, hop_length=64, device="cpu")
    jrt = JT.RealtimeSTFT(n_fft=256, hop_length=64)
    assert rt.get_batch_size() == jrt.get_batch_size() == 2
    rt.set_batch_size(7)
    jrt.set_batch_size(7)
    assert rt.get_batch_size() == jrt.get_batch_size() == 7


@pytest.mark.parametrize("event_ndim", [0, 1, 2])
def test_reshape_batches_vs_jax(event_ndim):
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    fj, bj = j_reshape_batches(jnp.asarray(x), event_ndim)
    fp, bp = p_reshape_batches(torch.as_tensor(x), event_ndim)
    same(fj, fp)
    assert tuple(bj) == bp


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (1024, 256), (512, 100)])
def test_matmul2_vs_jax_and_oracle(audio, n_fft, hop):
    x = audio.mean(1)
    w = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    sj = np.asarray(jfft.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(w), impl="matmul2"))
    sp = pfft.stft(torch.as_tensor(x), n_fft, hop, torch.as_tensor(w), impl="matmul2").numpy()
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    so = np.fft.rfft(xp[:, idx] * w.astype(np.float64), axis=-1)
    assert sp.shape == sj.shape == so.shape
    assert rel(sp, sj) <= 1e-5 and rel(sp, so) <= 1e-5
    # the inverse of matmul2 is the direct product, as in the JAX package
    yp = pfft.istft(torch.as_tensor(sp), n_fft, hop, torch.as_tensor(w), impl="matmul2").numpy()
    yj = np.asarray(jfft.istft(jnp.asarray(sj), n_fft, hop, jnp.asarray(w), impl="matmul2"))
    assert rel(yp, yj) <= 1e-5 and rel(yp, x[:, : yp.shape[-1]]) <= 1e-4


def test_matmul2_in_the_transforms_and_odd_n_fft(audio):
    x = torch.as_tensor(audio.mean(1))
    a = PT.STFT(n_fft=256, hop_length=64, impl="matmul2", device="cpu").forward(x)
    b = PT.STFT(n_fft=256, hop_length=64, device="cpu").forward(x)
    assert rel(a.numpy(), b.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="even n_fft"):
        pfft.rfft_frames(torch.zeros(2, 255), impl="matmul2")
    with pytest.raises(ValueError, match="unknown fft impl"):
        pfft.rfft_frames(torch.zeros(2, 256), impl="radix3")


def test_matmul_precision_setter_and_the_default_against_float64(audio):
    assert pfft.matmul_precision() == "highest" and torch.get_float32_matmul_precision() == "highest"
    try:
        for name, torch_name in (("default", "medium"), ("high", "high"), ("highest", "highest")):
            pfft.set_matmul_precision(name)
            assert pfft.matmul_precision() == name and torch.get_float32_matmul_precision() == torch_name
    finally:
        pfft.set_matmul_precision("highest")
    with pytest.raises(ValueError, match="matmul precision"):
        pfft.set_matmul_precision("bf16x3")
    assert pfft.matmul_precision() == "highest"
    x = audio.mean(1)
    n_fft, hop = 1024, 256
    w = np.hanning(n_fft + 1)[:-1]
    sp = pfft.stft(torch.as_tensor(x), n_fft, hop, torch.as_tensor(w.astype(np.float32))).numpy()
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    so = np.fft.rfft(xp[:, idx] * w, axis=-1)
    assert rel(sp, so) <= 1e-5
