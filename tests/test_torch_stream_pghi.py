"""The streaming RT-PGHI path of the port (``RealtimeSTFT`` / ``RealtimeDGT``
in modes ``pghi`` / ``pghi_exact``, ``streaming.scan_roundtrip`` /
``scan_invert`` with ``inversion_mode="pghi"``, the sessions N and Q of
``ops/cuda/stream_step.py`` and ``convert.load_jax_stream_state``) against the
JAX package on the same numpy inputs, at n_fft 512/128 with chunks of 1024
samples (8 frames: the JAX ``pghi_scan`` takes its serial form) and two
sessions of four chunks with a ragged tail.

Tolerances, and why:

* the eager steps, with the JAX draws handed to the port as ``angles=``:
  frames within 1e-4 of their largest value, ``mag_buffer`` within 1e-5,
  ``phase_buffer`` on the circle within 1e-4 rad (float32 sums in another
  order; low tones, so the phases stay small);
* the plain versions of N and Q against the JAX Pallas kernels in interpret
  mode: within 1e-3 of the largest value, as held for M and P (the TPU
  products are bf16x4, and the JAX kernel carries the phase unwrapped where
  the port re-wraps it per chunk);
* the kernel route against the port's own generic scan with a generator in
  the same state: phases on the audible bins within 1e-3 rad on the circle,
  spectral convergence within ``1.1 s + 1e-3`` of the scan's (``bench.py:582,
  664``).

No anchor decision flips between the compared runs at these inputs: every
audible bin's phase agrees within 1e-3 rad, which a flip (a ridge integrated
from another anchor) would break; the card's runs, where the kernel's
magnitudes round otherwise than the scan's, are held by spectral convergence
(``chip_smoke.py`` phase 4g).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu import streaming as JS
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.convert import load_jax_stream_state
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.pghi import random_angles
from test_torch_common import make_audio, rel, t2n, tones
from test_torch_streaming import chains, spectral_convergence

N_FFT, HOP, CHUNK = 512, 128, 1024
T_C = CHUNK // HOP
F = N_FFT // 2 + 1


def circle(a, b):
    """Largest distance of two phase arrays on the circle (radians)."""
    d = np.angle(np.exp(1j * (np.float64(a) - np.float64(b))))
    return float(np.abs(d).max()) if d.size else 0.0


def chunk_mags(kind, n=3 * CHUNK + 300, seed=None):
    """Per-chunk magnitudes ``(2, n_chunks * T_C, F)`` of two low-tone
    streams (or seeded audio), as the generic scan's forward makes them."""
    x = tones(n, [(220, 440, 880), (330, 660)]) if seed is None else make_audio(seed, batch=2, n=n)[:, 0]
    _, pc = chains(N_FFT, HOP, kind, mode="pghi")
    spec, _ = PS.scan_forward(pc, torch.as_tensor(x), CHUNK, backend="generic")
    return x, t2n(spec.abs())


@pytest.fixture(scope="module")
def session():
    x = make_audio(11, batch=2, n=3 * CHUNK + 300)[:, 0]   # 4 chunks, ragged tail
    key = jax.random.PRNGKey(13)
    n_chunks = -(-x.shape[-1] // CHUNK)
    ang = np.array(JK._session_angles(key, n_chunks, T_C, F, 384, (2,)))[..., :F]
    return x, key, ang


@pytest.mark.parametrize("mode", ["pghi", "pghi_exact"])
@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_init_state_shapes_match_jax(kind, mode):
    jc, pc = chains(N_FFT, HOP, kind, mode="pghi")
    js, ps = jc[1].init_state((3,), mode=mode), pc[1].init_state((3,), mode=mode)
    assert {k: tuple(v.shape) for k, v in ps.items()} == {k: v.shape for k, v in js.items()}
    assert set(ps) == {"mag_buffer", "phase_buffer"}
    assert ps["mag_buffer"].shape == (3, 2, F) and all(v.abs().max() == 0 for v in ps.values())
    # the chain's state: OverlapAdd's ring, then the RT-PGHI history
    jcs, pcs = jc.init_state((3,), mode=mode), pc.init_state((3,), mode=mode)
    assert [sorted(s) for s in pcs] == [sorted(s) for s in jcs]


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_two_chained_step_inverts_match_jax(kind):
    """``step_invert(pghi)`` twice, state carried: frames, ``mag_buffer`` and
    ``phase_buffer`` as the JAX package's, its draws pinned."""
    jc, pc = chains(N_FFT, HOP, kind, mode="pghi")
    _, mags = chunk_mags(kind)
    js, ps = jc[1].init_state((2,), mode="pghi"), pc[1].init_state((2,), mode="pghi")
    for i in range(2):
        m = mags[:, i * T_C: (i + 1) * T_C]
        key = jax.random.PRNGKey(20 + i)
        js, jy = jc[1].step_invert(js, jnp.asarray(m), inversion_mode="pghi", key=key)
        draws = np.array(2.0 * jnp.pi * jax.random.uniform(key, m.shape))
        ps, py = pc[1].step_invert(ps, torch.as_tensor(m), inversion_mode="pghi", angles=torch.as_tensor(draws))
        assert py.shape == jy.shape == (2, T_C, N_FFT)
        assert rel(t2n(py), np.array(jy)) <= 1e-4, i
        assert np.abs(t2n(ps["mag_buffer"]) - np.array(js["mag_buffer"])).max() <= 1e-5 * mags.max()
        loud = np.array(js["mag_buffer"])[:, 1] > 1e-2 * m.max()
        assert circle(t2n(ps["phase_buffer"])[loud], np.array(js["phase_buffer"])[loud]) <= 1e-4
    # pghi_exact streams as pghi: the same frames from the same state
    st = pc[1].init_state((2,), mode="pghi")
    a = torch.as_tensor(random_angles((2, T_C, F), "cpu", torch.Generator().manual_seed(1)))
    _, y1 = pc[1].step_invert(st, torch.as_tensor(mags[:, :T_C]), "pghi", angles=a)
    mode = "pghi_exact" if kind == "dgt" else "pghi"
    _, y2 = pc[1].step_invert(st, torch.as_tensor(mags[:, :T_C]), mode, angles=a)
    assert torch.equal(y1, y2)
    with pytest.raises(KeyError, match="PGHI history"):
        pc[1].pghi_stream({}, torch.as_tensor(mags[:, :T_C]))


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_eager_random_keeps_the_pghi_history(kind):
    """An eager ``random`` call keeps the RT-PGHI history, so a switch to
    ``pghi`` continues from real context, as in the JAX package (its random
    draw handed to JAX as ``keep_input``'s phase)."""
    jc, pc = chains(N_FFT, HOP, kind, mode="pghi")
    _, mags = chunk_mags(kind)
    m1, m2 = mags[:, :T_C], mags[:, T_C: 2 * T_C]
    g = torch.Generator().manual_seed(3)
    draw = t2n(random_angles(m1.shape, "cpu", torch.Generator().manual_seed(3)))
    py1 = pc[1].invert(torch.as_tensor(m1), inversion_mode="random", generator=g)
    jy1 = jc[1].invert(jnp.asarray(m1), inversion_mode="keep_input", phase=jnp.asarray(draw))
    assert rel(t2n(py1), np.array(jy1)) <= 1e-5
    st = pc[1]._state
    assert np.abs(t2n(st["mag_buffer"]) - np.array(jc[1]._state["mag_buffer"])).max() <= 1e-5 * m1.max()
    key = jax.random.PRNGKey(4)
    jy2 = jc[1].invert(jnp.asarray(m2), inversion_mode="pghi", key=key)
    draws = torch.as_tensor(np.array(2.0 * jnp.pi * jax.random.uniform(key, m2.shape)))
    py2 = pc[1].invert(torch.as_tensor(m2), inversion_mode="pghi", angles=draws)
    assert rel(t2n(py2), np.array(jy2)) <= 1e-4
    # the history mattered: a fresh session's first frames differ
    _, fresh = pc[1].step_invert(pc[1].init_state((2,), mode="pghi"), torch.as_tensor(m2), "pghi", angles=draws)
    assert rel(t2n(fresh), t2n(py2)) > 1e-2


def test_recurrence_plain_version_equals_the_generic_scans_phases():
    """The session recurrence's plain version against ``pghi_stream`` chunk by
    chunk (carry through ``_update_buffers``), same angles: the anchors agree
    and the audible bins' phases agree on the circle within 1e-3 rad."""
    rt = PT.RealtimeDGT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    _, mags = chunk_mags("dgt", seed=12)
    mags = torch.as_tensor(mags)
    T = mags.shape[1]
    a = PK.session_angles((2,), T // T_C, T_C, F, "cpu", torch.Generator().manual_seed(6))
    got = PK.rt_pghi_phases_reference(mags, a, rt.gamma, N_FFT, HOP, rt.tolerance, T_C)
    assert torch.equal(PK.rt_pghi_phases(mags, a, rt.gamma, N_FFT, HOP, rt.tolerance, T_C), got)
    st, ref = rt.init_state((2,), mode="pghi"), []
    for c in range(T // T_C):
        m = mags[:, c * T_C: (c + 1) * T_C]
        ph = rt.pghi_stream(st, m, angles=a[:, c * T_C: (c + 1) * T_C])
        st = rt._update_buffers(st, torch.polar(m, ph))
        ref.append(ph)
    ref = torch.cat(ref, dim=1)
    mx = mags.reshape(2, -1, T_C * F).amax(-1).repeat_interleave(T_C, 1)[..., None]
    loud = (mags > 1e-2 * mx).numpy()
    assert loud.mean() > 0.05
    assert circle(t2n(got)[loud], t2n(ref)[loud]) <= 1e-3
    assert np.array_equal(t2n(got)[~loud], t2n(a)[~loud])
    with pytest.raises(ValueError, match="whole number"):
        PK.rt_pghi_phases_reference(mags[:, :-1], a, rt.gamma, N_FFT, HOP, rt.tolerance, T_C)


def test_n_roundtrip_plain_vs_pallas(session):
    x, key, ang = session
    jc, pc = chains(N_FFT, HOP, "stft", mode="pghi")
    y_k = PK.make_fused_pghi_roundtrip(pc, CHUNK, angles=torch.as_tensor(ang))(torch.as_tensor(x))
    y_j = JK.make_fused_pghi_roundtrip(jc, CHUNK, key=key, interpret=True)(jnp.asarray(x))
    assert y_k.shape == y_j.shape == (2, 4 * CHUNK)
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-3


def test_q_decode_plain_vs_pallas(session):
    x, key, ang = session
    jc, pc = chains(N_FFT, HOP, "dgt", mode="pghi")
    spec, _ = PK.make_fused_forward_session(pc, CHUNK)(torch.as_tensor(x))
    mags = spec.abs()[:, :-3]                       # a ragged last chunk of frames
    T = mags.shape[1]
    y_k = PK.make_fused_pghi_invert(pc, T_C, angles=torch.as_tensor(ang))(mags)
    y_j = JK.make_fused_pghi_invert(jc, T_C, key=key, interpret=True)(jnp.asarray(t2n(mags)))
    assert y_k.shape == y_j.shape == (2, T * HOP)
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-3
    # one stream without a batch axis decodes as the first of the batch
    y1 = PK.make_fused_pghi_invert(pc, T_C, angles=torch.as_tensor(ang[:1]))(mags[0])
    assert y1.shape == (T * HOP,) and rel(t2n(y1), t2n(y_k[0])) <= 1e-6


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_fused_routes_match_the_generic_scan(kind):
    """``scan_roundtrip`` / ``scan_invert`` in ``pghi`` mode, the session
    route (``backend="fused"``: the kernels' plain versions on the CPU)
    against the chunk scan with a generator in the same state."""
    x = make_audio(15, batch=2, n=3 * CHUNK + 300)[:, 0]
    _, pc = chains(N_FFT, HOP, kind, mode="pghi")
    xt = torch.as_tensor(x)
    d = N_FFT - HOP
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    y_f = t2n(PS.scan_roundtrip(pc, xt, CHUNK, "pghi", generator=g1, backend="fused"))
    y_g = t2n(PS.scan_roundtrip(pc, xt, CHUNK, "pghi", generator=g2, backend="generic"))
    assert y_f.shape == y_g.shape == (2, 4 * CHUNK) and rel(y_f, y_g) <= 1e-3
    s_f, s_g = spectral_convergence(y_f[:, d:], x, N_FFT, HOP), spectral_convergence(y_g[:, d:], x, N_FFT, HOP)
    assert s_f <= 1.1 * s_g + 1e-3, (s_f, s_g)
    # the decode of the generic forward's magnitudes, ragged
    spec, _ = PS.scan_forward(pc, xt, CHUNK, backend="generic")
    mags = spec.abs()[:, :-3]
    g1, g2 = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    d_f = t2n(PS.scan_invert(pc, mags, T_C, "pghi", generator=g1, backend="fused"))
    d_g = t2n(PS.scan_invert(pc, mags, T_C, "pghi", generator=g2, backend="generic"))
    assert d_f.shape == d_g.shape and rel(d_f, d_g) <= 1e-3
    s_f, s_g = spectral_convergence(d_f[:, d:], x, N_FFT, HOP), spectral_convergence(d_g[:, d:], x, N_FFT, HOP)
    assert s_f <= 1.1 * s_g + 1e-3, (s_f, s_g)
    # the 3-chain: the magnitude encode, Magnitude forward and invert, Q
    three = pc + PT.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=N_FFT, device="cpu")
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    t_f = t2n(PS.scan_roundtrip(three, xt, CHUNK, "pghi", generator=g1, backend="fused"))
    t_g = t2n(PS.scan_roundtrip(three, xt, CHUNK, "pghi", generator=g2, backend="generic"))
    assert t_f.shape == t_g.shape and rel(t_f, t_g) <= 1e-3
    mag_f = PK.make_fused_magnitude_session(pc, CHUNK)(xt)
    assert rel(t2n(mag_f), t2n(spec.abs())) <= 1e-5


def test_resume_a_jax_pghi_session_in_the_port():
    """Two chunks of a JAX ``pghi`` roundtrip, its state carried across by
    ``convert``, two more chunks in each package (the JAX draws pinned): the
    continuation's audio and RT-PGHI history agree."""
    x = tones(4 * CHUNK, [(220, 440, 880), (330, 660)])
    jc, pc = chains(N_FFT, HOP, "dgt", mode="pghi")

    def jax_chunk(st, c, i):
        st0, fr = jc[0].step(st[0], jnp.asarray(c))
        mag = jnp.abs(jc[1].forward(fr))
        key = jax.random.PRNGKey(40 + i)
        st1, y = jc[1].step_invert(st[1], mag, inversion_mode="pghi", key=key)
        st0, out = jc[0].step_invert(st0, y)
        return [st0, st1], out, np.array(2.0 * jnp.pi * jax.random.uniform(key, mag.shape))

    jst = jc.init_state((2,), mode="pghi")
    for i in range(2):
        jst, _, _ = jax_chunk(jst, x[:, i * CHUNK: (i + 1) * CHUNK], i)
    pst = load_jax_stream_state(pc, jax.tree_util.tree_map(np.asarray, jst))
    assert set(pst[1]) == {"mag_buffer", "phase_buffer"} and pst[1]["mag_buffer"].shape == (2, 2, F)
    for i in range(2, 4):
        c = x[:, i * CHUNK: (i + 1) * CHUNK]
        jst, jout, draws = jax_chunk(jst, c, i)
        st0, fr = pc[0].step(pst[0], torch.as_tensor(c))
        st1, y = pc[1].step_invert(pst[1], pc[1].forward(fr).abs(), "pghi", angles=torch.as_tensor(draws))
        st0, pout = pc[0].step_invert(st0, y)
        pst = [st0, st1]
        assert rel(t2n(pout), np.array(jout)) <= 1e-4, i
    assert np.abs(t2n(pst[1]["mag_buffer"]) - np.array(jst[1]["mag_buffer"])).max() <= 1e-5
    # a random session's empty carry comes across into a pghi-configured chain
    st = load_jax_stream_state(pc, [jax.tree_util.tree_map(np.asarray, jst[0]), {}])
    assert st[1] == {}
    with pytest.raises(ValueError, match="batch shapes"):
        load_jax_stream_state(pc, [jst[0], {"mag_buffer": np.zeros((3, 2, F)), "phase_buffer": np.zeros((2, F))}])
    with pytest.raises(ValueError, match="shape"):
        load_jax_stream_state(pc, [jst[0], {"mag_buffer": np.zeros((2, 3, F)), "phase_buffer": np.zeros((2, F))}])


def test_dispatch_of_the_pghi_and_complex_sessions():
    """On a CUDA tensor (data only: the plan reads the device type) ``auto``
    and ``fused`` take the RT-PGHI and complex-decode sessions; on a CPU one
    ``auto`` runs the chunk scan; ``pghi_exact`` streams through the scan as
    in the JAX package; ``pghi_gl`` takes its own session (O) and
    ``sinebank`` its closed form."""
    _, pc = chains(N_FFT, HOP, "dgt", mode="pghi")
    three = pc + PT.Magnitude(device="cpu", n_fft=N_FFT)
    shape, yshape = (4, 4096), (4, 40, F)
    for dev in ("cpu", "cuda"):
        card = dev == "cuda"
        for chain in (pc, three):
            assert PS.plan_roundtrip(chain, shape, CHUNK, "pghi", device=dev) == ("pghi" if card else "generic")
            assert PS.plan_roundtrip(chain, shape, CHUNK, "pghi", backend="fused", device=dev) == "pghi"
            assert PS.plan_invert(chain, yshape, T_C, "pghi", device=dev) == ("pghi" if card else "generic")
            assert PS.plan_roundtrip(chain, shape, CHUNK, "pghi_exact", device=dev) == "generic"
        assert PS.plan_invert(pc, yshape, T_C, None, y_is_complex=True, device=dev) == ("complex" if card else "generic")
        assert PS.plan_invert(three, yshape, T_C, None, y_is_complex=True, device=dev) == "generic"
        assert PS.plan_roundtrip(pc, shape, CHUNK, "pghi_gl", backend="fused", device=dev) == "pghi_gl"
        assert PS.plan_roundtrip(pc, shape, CHUNK, "sinebank", backend="fused", device=dev) == "sinebank"
    # JAX's own plans agree on which session covers each call
    jc = JT.OverlapAdd(N_FFT, HOP) + JT.RealtimeDGT(n_fft=N_FFT, hop_length=HOP)
    assert JS.plan_roundtrip(jc, shape, CHUNK, "pghi", backend="fused") == "pghi"
    assert JS.plan_invert(jc, yshape, T_C, None, y_is_complex=True, backend="fused") == "complex"
