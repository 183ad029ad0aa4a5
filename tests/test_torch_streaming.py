"""The streaming layer of the port (``transforms/oadd.py``, ``RealtimeSTFT`` /
``RealtimeDGT``, ``streaming.py``, ``convert.load_jax_stream_state``) against
the JAX package on the same numpy inputs, at n_fft 512/128 and 256/64 with
chunks of 1024 samples and a ragged tail.

Tolerances: exact operations (framing, the complex spectrum and the complex
roundtrip) 1e-5 of the output's largest value (float32 products in another
order); the streaming unity gain above 60 dB after the ``(overlap - 1) hop``
delay (``tests/test_streaming.py``).  Random phases cannot be drawn alike in
both frameworks, so the JAX package's draws are handed to the port as a
phase, or the two are compared on quality (spectral convergence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu import streaming as JS
from acids_transforms_tpu.ops.fft import rfft_frames as j_rfft_frames
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.convert import load_jax_state, load_jax_stream_state
from acids_transforms_tpu_torch.ops.fft import rfft_frames
from test_torch_common import Mesh4, make_audio, rel, t2n

SHAPES = [(512, 128), (256, 64)]
CHUNK = 1024


def signal(seed=0, batch=2, n=3 * CHUNK + 300):
    """Seeded mono streams with a ragged tail (no multiple of the chunk)."""
    return make_audio(seed, batch=batch, n=n)[:, 0]


def chains(n_fft, hop, kind="stft", mode="random"):
    if kind == "dgt":
        j = JT.OverlapAdd(n_fft, hop) + JT.RealtimeDGT(n_fft=n_fft, hop_length=hop, inversion_mode=mode)
        p = PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeDGT(
            n_fft=n_fft, hop_length=hop, inversion_mode=mode, device="cpu")
    else:
        j = JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, inversion_mode=mode)
        p = PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(
            n_fft=n_fft, hop_length=hop, inversion_mode=mode, device="cpu")
    return j, p


def spectral_convergence(y, x, n_fft, hop):
    """|| |STFT(y)| - |STFT(x)| || / || |STFT(x)| || on the common length."""
    n = min(y.shape[-1], x.shape[-1])
    w = torch.hann_window(n_fft, dtype=torch.float64)
    S = lambda s: torch.stft(torch.as_tensor(s[..., :n], dtype=torch.float64), n_fft, hop, window=w,
                             return_complex=True).abs()
    a, b = S(y), S(x)
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


@pytest.mark.parametrize("impl", ["matmul", "fft"])
def test_rfft_frames_matches_jax(impl):
    fr = np.random.default_rng(1).standard_normal((3, 5, 512)).astype(np.float32)
    p = rfft_frames(torch.as_tensor(fr), impl=impl)
    j = j_rfft_frames(jnp.asarray(fr), impl=impl)
    assert p.shape == j.shape and p.is_complex()
    assert rel(t2n(p), np.array(j)) <= 1e-5
    # the radix-2 split is ported: it agrees with the JAX package's
    p2 = rfft_frames(torch.as_tensor(fr), impl="matmul2")
    assert rel(t2n(p2), np.array(j_rfft_frames(jnp.asarray(fr), impl="matmul2"))) <= 1e-5


@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_overlap_add_steps_and_eager_match_jax(n_fft, hop):
    x = signal(1)
    jo, po = JT.OverlapAdd(n_fft, hop), PT.OverlapAdd(n_fft, hop, device="cpu")
    js, ps = jo.init_state((2,)), po.init_state((2,))
    assert {k: v.shape for k, v in js.items()} == {k: tuple(v.shape) for k, v in ps.items()}
    jo_e, po_e = JT.OverlapAdd(n_fft, hop), PT.OverlapAdd(n_fft, hop, device="cpu")
    for i in range(3):
        seg = x[:, i * CHUNK: (i + 1) * CHUNK]
        js, jf = jo.step(js, jnp.asarray(seg))
        ps, pf = po.step(ps, torch.as_tensor(seg))
        assert rel(t2n(pf), np.array(jf)) <= 1e-6
        js, jy = jo.step_invert(js, jf * 0.5)
        ps, py = po.step_invert(ps, pf * 0.5)
        assert rel(t2n(py), np.array(jy)) <= 1e-5
        for k in js:
            assert np.allclose(t2n(ps[k]), np.array(js[k]), atol=1e-6)
        # the eager wrappers keep the same state on self
        ef, pe = jo_e.forward(jnp.asarray(seg)), po_e.forward(torch.as_tensor(seg))
        assert rel(t2n(pe), np.array(ef)) <= 1e-6
        assert rel(t2n(po_e.invert(pe)), np.array(jo_e.invert(ef))) <= 1e-5
    assert po.gain_compensation == jo.gain_compensation == n_fft // hop
    with pytest.raises(ValueError, match="dim=-1"):
        PT.OverlapAdd(n_fft, hop, dim=0, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        PT.OverlapAdd(n_fft, hop + 1, device="cpu")


@pytest.mark.parametrize("kind", ["stft", "dgt"])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_realtime_forward_and_windows_match_jax(n_fft, hop, kind):
    jc, pc = chains(n_fft, hop, kind)
    assert rel(t2n(pc[1].window), np.array(jc[1].window)) <= 1e-6
    assert rel(t2n(pc[1].inv_window), np.array(jc[1].inv_window)) <= 1e-6
    fr = np.random.default_rng(2).standard_normal((2, 7, n_fft)).astype(np.float32)
    p = pc[1].forward(torch.as_tensor(fr))
    j = jc[1].forward(jnp.asarray(fr))
    assert rel(t2n(p), np.array(j)) <= 1e-5
    # one frame without a frame axis, and the framed test hook
    assert rel(t2n(pc[1].forward(torch.as_tensor(fr[0, 0]))), np.array(jc[1].forward(jnp.asarray(fr[0, 0])))) <= 1e-5
    x = signal(3)
    assert rel(t2n(pc[1].test_forward(torch.as_tensor(x))), np.array(jc[1].test_forward(jnp.asarray(x)))) <= 1e-5


def test_init_state_shapes_per_mode():
    jc, pc = chains(512, 128)
    for mode in (None, "keep_input", "random"):
        js, ps = jc.init_state((3,), mode=mode), pc.init_state((3,), mode=mode)
        assert len(ps) == 2 and ps[1] == {} and js[1] == {}
        assert {k: tuple(v.shape) for k, v in ps[0].items()} == {k: v.shape for k, v in js[0].items()}
        assert all(v.abs().max() == 0 for v in ps[0].values())
    assert PT.Mono(device="cpu").init_state((3,)) is None
    # pghi: the RT-PGHI history, as in the JAX package
    js, ps = jc[1].init_state((3,), mode="pghi"), pc[1].init_state((3,), mode="pghi")
    assert {k: tuple(v.shape) for k, v in ps.items()} == {k: v.shape for k, v in js.items()}
    assert set(ps) == {"mag_buffer", "phase_buffer"}
    # pghi_gl: that history and the pinned context, as in the JAX package
    js, ps = jc[1].init_state((3,), mode="pghi_gl"), pc[1].init_state((3,), mode="pghi_gl")
    assert {k: tuple(v.shape) for k, v in ps.items()} == {k: v.shape for k, v in js.items()}
    assert set(ps) == {"mag_buffer", "phase_buffer", "gl_mag", "gl_phase"}
    # sinebank: the oscillators' clock (one scalar) and phases, as in the JAX package
    js = jc[1].init_state((3,), mode="sinebank")
    ps = pc[1].init_state((3,), mode="sinebank", generator=torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in ps.items()} == {k: v.shape for k, v in js.items()}
    assert {k: tuple(v.shape) for k, v in ps.items()} == {"time_index": (), "random_phase": (3, 1, 257)}
    assert ps["time_index"] == 0 and 0 <= ps["random_phase"].min() and ps["random_phase"].max() < 2 * np.pi
    # the DGT's default mode is pghi: it streams
    st = PT.RealtimeDGT(n_fft=512, hop_length=128, device="cpu").init_state((1,))
    assert {k: tuple(v.shape) for k, v in st.items()} == {"mag_buffer": (1, 2, 257), "phase_buffer": (1, 257)}


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_step_invert_matches_jax_per_mode(kind):
    """``None`` on the complex spectrum, ``keep_input`` with the phase of the
    last forward, and ``random`` with the JAX package's draws given as the
    phase: frames within 1e-5."""
    jc, pc = chains(512, 128, kind)
    fr = np.random.default_rng(4).standard_normal((2, 8, 512)).astype(np.float32)
    jspec = jc[1].forward(jnp.asarray(fr))
    pspec = pc[1].forward(torch.as_tensor(fr))
    _, jy = jc[1].step_invert({}, jspec)
    st, py = pc[1].step_invert({}, pspec)
    assert st == {} and rel(t2n(py), np.array(jy)) <= 1e-5
    _, jy = jc[1].step_invert({}, jnp.abs(jspec), inversion_mode="keep_input")
    _, py = pc[1].step_invert({}, pspec.abs(), inversion_mode="keep_input")
    assert rel(t2n(py), np.array(jy)) <= 1e-5
    key = jax.random.PRNGKey(7)
    _, jy = jc[1].step_invert({}, jnp.abs(jspec), inversion_mode="random", key=key)
    draws = np.array(2.0 * jnp.pi * jax.random.uniform(key, jspec.shape))
    py = pc[1].invert(pspec.abs(), inversion_mode="keep_input", phase=torch.as_tensor(draws))
    assert rel(t2n(py), np.array(jy)) <= 1e-5
    # the port's own draws: a generator in the same state gives the same frames
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    _, a = pc[1].step_invert({}, pspec.abs(), inversion_mode="random", generator=g1)
    _, b = pc[1].step_invert({}, pspec.abs(), inversion_mode="random", generator=g2)
    assert torch.equal(a, b)


def test_session_frame_times_match_jax():
    jc, pc = chains(512, 128)
    j = np.array(JS.session_frame_times(jc, CHUNK, 4))
    p = t2n(PS.session_frame_times(pc, CHUNK, 4))
    assert p.shape == j.shape == (4 * CHUNK // 128,)
    assert np.allclose(p, j, rtol=0, atol=1e-6)
    jf, jt = jc.forward_with_time(jnp.zeros(CHUNK), jnp.zeros(()))
    pf, pt = pc.forward_with_time(torch.zeros(CHUNK), torch.zeros(()))
    assert np.allclose(t2n(pt), np.array(jt), atol=1e-7)
    # the probe runs on a copy: the caller's eager ring is untouched
    assert pc[0]._state is not None and float(pc[0]._state["input_buffer"].abs().max()) == 0.0


@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_generic_scans_match_jax(n_fft, hop):
    x = signal(5)
    jc, pc = chains(n_fft, hop)
    jf, jst = JS.scan_forward(jc, jnp.asarray(x), CHUNK, backend="generic")
    pf, pst = PS.scan_forward(pc, torch.as_tensor(x), CHUNK, backend="generic")
    assert pf.shape == jf.shape and rel(t2n(pf), np.array(jf)) <= 1e-5
    assert np.allclose(t2n(pst[0]["input_buffer"]), np.array(jst[0]["input_buffer"]), atol=1e-7)
    jy = JS.scan_roundtrip(jc, jnp.asarray(x), CHUNK, backend="generic")
    py = PS.scan_roundtrip(pc, torch.as_tensor(x), CHUNK, backend="generic")
    assert py.shape == jy.shape and rel(t2n(py), np.array(jy)) <= 1e-5
    # complex decode of the forward's spectrum: the generic scan on both sides
    T_c = CHUNK // hop
    jd = JS.scan_invert(jc, jf[:, :-3], T_c, backend="generic")
    pd = PS.scan_invert(pc, pf[:, :-3], T_c, backend="generic")
    assert pd.shape == jd.shape and rel(t2n(pd), np.array(jd)) <= 1e-5
    with_t = PS.scan_forward(pc, torch.as_tensor(x), CHUNK, backend="generic", with_time=True)
    jwt = JS.scan_forward(jc, jnp.asarray(x), CHUNK, backend="generic", with_time=True)
    assert np.allclose(t2n(with_t[1]), np.array(jwt[1]), atol=1e-6)
    # random: other draws on each side, the same quality
    jr = np.array(JS.scan_roundtrip(jc, jnp.asarray(x), CHUNK, "random", key=jax.random.PRNGKey(2),
                                    backend="generic"))
    pr = t2n(PS.scan_roundtrip(pc, torch.as_tensor(x), CHUNK, "random",
                               generator=torch.Generator().manual_seed(2), backend="generic"))
    d = n_fft - hop
    s_j = spectral_convergence(jr[:, d:], x, n_fft, hop)
    s_p = spectral_convergence(pr[:, d:], x, n_fft, hop)
    assert s_p <= max(1.15 * s_j, s_j + 0.02), (s_p, s_j)
    jm = np.array(JS.scan_invert(jc, jnp.abs(jf), T_c, "random", key=jax.random.PRNGKey(2), backend="generic"))
    pm = t2n(PS.scan_invert(pc, pf.abs(), T_c, "random", generator=torch.Generator().manual_seed(2),
                            backend="generic"))
    s_j = spectral_convergence(jm[:, d:], x, n_fft, hop)
    s_p = spectral_convergence(pm[:, d:], x, n_fft, hop)
    assert pm.shape == jm.shape and s_p <= max(1.15 * s_j, s_j + 0.02), (s_p, s_j)


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_streaming_unity_gain_after_the_delay(kind):
    """OverlapAdd + Realtime* complex roundtrip reconstructs at unity gain,
    delayed by (overlap - 1) hop samples: above 60 dB."""
    n_fft, hop = 512, 128
    _, pc = chains(n_fft, hop, kind)
    x = signal(6, batch=1, n=6 * CHUNK)[0]
    y = t2n(PS.scan_roundtrip(pc, torch.as_tensor(x), CHUNK))
    d = n_fft - hop
    n = y.shape[-1] - d - n_fft
    err = y[d: d + n] - x[:n]
    snr = 10 * np.log10(np.sum(x[:n] ** 2) / np.sum(err ** 2))
    assert snr > 60, snr
    outs = pc[1].test_inversion(torch.as_tensor(x))
    phaseless = {"keep_input", "random", "pghi", "pghi_gl", "sinebank"} | ({"pghi_exact"} if kind == "dgt" else set())
    assert set(outs) == {"direct"} | phaseless
    assert all(outs[m].shape == outs["direct"].shape and torch.isfinite(outs[m]).all() for m in phaseless)
    assert rel(t2n(outs["direct"])[d: d + n], x[:n]) <= 1e-4
    assert rel(t2n(outs["keep_input"])[d: d + n], x[:n]) <= 1e-4


def test_resume_a_jax_session_in_the_port():
    """A JAX streaming state carried across through ``convert`` resumes in
    the port's ``scan_forward``: the continuation's frames and final state
    equal the JAX continuation's."""
    x = signal(7, n=5 * CHUNK)
    jc, pc = chains(512, 128)
    _, jst = JS.scan_forward(jc, jnp.asarray(x[:, : 2 * CHUNK]), CHUNK, backend="generic")
    state = load_jax_stream_state(pc, jax.tree_util.tree_map(np.asarray, jst))
    assert state[1] == {} and state[0]["input_buffer"].dtype == torch.float32
    jf, jst2 = JS.scan_forward(jc, jnp.asarray(x[:, 2 * CHUNK:]), CHUNK, state=jst, backend="generic")
    pf, pst2 = PS.scan_forward(pc, torch.as_tensor(x[:, 2 * CHUNK:]), CHUNK, state=state)
    assert rel(t2n(pf), np.array(jf)) <= 1e-5
    assert np.allclose(t2n(pst2[0]["input_buffer"]), np.array(jst2[0]["input_buffer"]), atol=1e-7)
    # the whole session in one go gives the same frames
    whole, _ = PS.scan_forward(pc, torch.as_tensor(x), CHUNK)
    assert rel(t2n(pf), t2n(whole[:, 2 * CHUNK // 128:])) <= 1e-6
    with pytest.raises(ValueError, match="entries"):
        load_jax_stream_state(pc, [None])
    with pytest.raises(ValueError, match="keys"):
        load_jax_stream_state(pc, [{"input_buffer": np.zeros((2, 384))}, {}])
    with pytest.raises(ValueError, match="shape"):
        load_jax_stream_state(pc, [{"input_buffer": np.zeros((2, 5)), "output_buffer": np.zeros((2, 5))}, {}])


def test_load_jax_state_takes_streaming_chains():
    jc, pc = chains(512, 128, "dgt")
    from test_torch_common import jax_state

    st = jax_state(jc)
    assert set(st) == {"1.window", "1.inv_window"}
    load_jax_state(pc, st)
    assert np.array_equal(t2n(pc[1].inv_window), st["1.inv_window"])


def test_dispatch_contract():
    """The port's rule: ``auto`` takes a session kernel on a CUDA tensor and
    the generic scan on a CPU one; ``fused`` takes the session on either
    device or raises ValueError; the sinebank's closed form (torch ops) is
    taken on either device; ``generic`` forces the scan."""
    _, pc = chains(512, 128)
    three = pc + PT.Magnitude(device="cpu", n_fft=512)
    shape = (4, 4096)
    for dev in ("cpu", "cuda"):
        card = dev == "cuda"
        assert PS.plan_forward(pc, shape, CHUNK, device=dev) == ("fused" if card else "generic")
        assert PS.plan_forward(three, shape, CHUNK, device=dev) == ("fused" if card else "generic")
        assert PS.plan_forward(pc, shape, CHUNK, has_state=True, device=dev) == "generic"
        assert PS.plan_roundtrip(pc, shape, CHUNK, device=dev) == ("complex" if card else "generic")
        assert PS.plan_roundtrip(pc, shape, CHUNK, "random", device=dev) == ("random" if card else "generic")
        assert PS.plan_roundtrip(three, shape, CHUNK, "random", device=dev) == ("random" if card else "generic")
        assert PS.plan_invert(pc, (4, 40, 257), 8, "random", device=dev) == ("random" if card else "generic")
        # RT-PGHI (N, Q) and the complex decode (S)
        assert PS.plan_roundtrip(pc, shape, CHUNK, "pghi", device=dev) == ("pghi" if card else "generic")
        assert PS.plan_roundtrip(three, shape, CHUNK, "pghi", device=dev) == ("pghi" if card else "generic")
        assert PS.plan_invert(pc, (4, 40, 257), 8, "pghi", device=dev) == ("pghi" if card else "generic")
        assert PS.plan_invert(pc, (4, 40, 257), 8, None, y_is_complex=True, device=dev) == (
            "complex" if card else "generic")
        assert PS.plan_invert(pc, (4, 40, 257), 8, None, y_is_complex=True, backend="fused", device=dev) == "complex"
        assert PS.plan_forward(pc, shape, CHUNK, backend="fused", device=dev) == "fused"
        assert PS.plan_roundtrip(pc, shape, CHUNK, backend="fused", device=dev) == "complex"
        for b in ("auto", "fused", "generic"):
            # a chain the kernels do not cover structurally: the chunk scan
            # (fused raises)
            if b == "fused":
                with pytest.raises(ValueError, match="backend='fused'"):
                    PS.plan_roundtrip(pc, shape, 1000, backend=b, device=dev)
                with pytest.raises(ValueError, match="backend='fused'"):
                    PS.plan_forward(pc[0], shape, CHUNK, backend=b, device=dev)
                with pytest.raises(ValueError, match="backend='fused'"):
                    PS.plan_roundtrip(three, shape, CHUNK, backend=b, device=dev)
            else:
                assert PS.plan_roundtrip(pc, shape, 1000, backend=b, device=dev) == "generic"
                assert PS.plan_roundtrip(three, shape, CHUNK, backend=b, device=dev) == "generic"
        # the pghi_gl sessions (O)
        assert PS.plan_roundtrip(pc, shape, CHUNK, "pghi_gl", device=dev) == ("pghi_gl" if card else "generic")
        assert PS.plan_invert(pc, (4, 40, 257), 8, "pghi_gl", device=dev) == ("pghi_gl" if card else "generic")
        assert PS.plan_roundtrip(pc, shape, CHUNK, "pghi_gl", backend="generic", device=dev) == "generic"
        # the sinebank's closed form: torch ops, taken under auto on either device
        for call in (
            lambda b: PS.plan_roundtrip(pc, shape, CHUNK, "sinebank", backend=b, device=dev),
            lambda b: PS.plan_invert(pc, (4, 40, 257), 8, "sinebank", backend=b, device=dev),
        ):
            assert call("generic") == "generic"
            assert call("fused") == "sinebank"
            assert call("auto") == "sinebank"
    assert PS.plan_forward(pc, shape, CHUNK) == "fused"  # device=None means the card
    for name, call in (("scan_roundtrip", PS.plan_roundtrip), ("scan_forward", PS.plan_forward)):
        with pytest.raises(ValueError, match="unknown %s backend" % name):
            call(pc, shape, CHUNK, backend="pallas")
    with pytest.raises(ValueError, match="unknown scan_invert backend"):
        PS.plan_invert(pc, (4, 40, 257), 8, backend="pallas")
    x = torch.as_tensor(signal(8))
    with pytest.raises(ValueError, match="batch axis"):   # mesh= runs: tests/test_torch_parallel.py
        PS.scan_roundtrip(pc, x[0], CHUNK, mesh=Mesh4())
    # backend="fused" on the CPU runs the sessions' plain versions
    assert rel(t2n(PS.scan_roundtrip(pc, x, CHUNK, backend="fused")),
               t2n(PS.scan_roundtrip(pc, x, CHUNK))) <= 1e-5


def test_unported_streaming_modes_raise_naming_roadmap():
    """``sinebank`` streams now: the eager step carries its clock on the
    transform, a state without the carry raises ``KeyError``, and the
    generic scan agrees with the closed form ``auto`` takes on the CPU."""
    _, pc = chains(512, 128)
    mag = torch.rand(2, 8, 257)
    y0 = pc[1].invert(mag, inversion_mode="sinebank")
    assert y0.shape == (2, 8, 512) and torch.isfinite(y0).all()
    assert pc[1]._state["time_index"] == torch.tensor(8 * 128 / 44100, dtype=torch.float32)
    with pytest.raises(KeyError, match="sinebank"):
        pc[1].step_invert({}, mag, inversion_mode="sinebank")
    x = torch.as_tensor(signal(9))
    y_g = PS.scan_roundtrip(pc, x, CHUNK, "sinebank", generator=torch.Generator().manual_seed(3), backend="generic")
    y_c = PS.scan_roundtrip(pc, x, CHUNK, "sinebank", generator=torch.Generator().manual_seed(3))
    assert y_g.shape == y_c.shape == (2, 4 * CHUNK)
    e = (torch.linalg.norm(y_c - y_g) / torch.linalg.norm(y_g)).item()
    assert e < 5e-3 and e < 1e-5   # JAX's bound, and the same angles' rounding
    # pghi_gl streams now (tests/test_torch_stream_pghi_gl.py)
    assert pc[1].invert(mag, inversion_mode="pghi_gl").shape == (2, 8, 512)


def test_realtime_variants_of_the_offline_transforms():
    st = PT.STFT(n_fft=512, hop_length=128, window="hamming", device="cpu")
    rt = st.realtime()
    assert type(rt) is PT.RealtimeSTFT and rt.inversion_mode == "random"
    assert (rt.n_fft, rt.hop_length, rt.window_name) == (512, 128, "hamming")
    assert PT.STFT(n_fft=512, hop_length=128, inversion_mode="keep_input", device="cpu").realtime(
    ).inversion_mode == "keep_input"
    dg = PT.DGT(n_fft=512, hop_length=128, device="cpu").realtime()
    assert type(dg) is PT.RealtimeDGT and dg.inversion_mode == "pghi" and dg.realtime() is dg
    jd = JT.DGT(n_fft=512, hop_length=128).realtime()
    assert rel(t2n(dg.inv_window), np.array(jd.inv_window)) <= 1e-6
    assert rel(t2n(dg.dual), np.array(jd.dual)) <= 1e-6 and dg.gamma == pytest.approx(jd.gamma)
    chain = (PT.Mono(device="cpu") + st).realtime()
    assert type(chain[1]) is PT.RealtimeSTFT and chain.device == st.device
